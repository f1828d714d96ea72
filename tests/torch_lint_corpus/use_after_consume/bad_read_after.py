"""BAD: state read after the call that wrote into it in place.

Counterparts of the reference's ``use_after_donate/bad_read_after.py``,
one function each, under the same names: where JAX deletes a donated
buffer, the port overwrites the consumed argument, so the old binding
(or an alias of it) silently reads the new state.
"""

import torch

from repro_torch.kernels.cow_write import cow_write


def read_after_donate(lm, params, tok, cache):
    logits, new = lm.decode_step(params, tok, cache)
    # 'cache' holds the new token's K/V but the old position: mixed state
    return cache.position, logits, new


def immediate_donate(data, src, dst, pos, values):
    out = cow_write(data, src, dst, pos, values)
    return data.sum() + out.sum()  # 'data' was written in place


@torch.library.custom_op("torch_lint_corpus::scale_into", mutates_args=("buf",))
def scale_into(buf: torch.Tensor, x: torch.Tensor) -> None:
    buf.copy_(x * 2)


def pallas_alias(buf, x):
    head = buf[0:4]  # a view: shares buf's storage
    scale_into(buf, x)  # mutates_args=("buf",): written in place
    return head.sum()


@torch.library.custom_op("torch_lint_corpus::fill_all", mutates_args="unknown")
def fill_all(buf: torch.Tensor, x: torch.Tensor) -> None:
    buf.fill_(1.0)


def through_torch_ops(buf, x):
    row = buf[0]
    torch.ops.torch_lint_corpus.scale_into.default(buf, x)
    return row


def unknown_mutation(buf, x):
    snap = (buf, x)
    fill_all(buf, x)  # mutates_args="unknown": every argument may be written
    return snap
