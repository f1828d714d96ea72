"""BAD: aliases bound before an in-place write, read after it."""

import torch

from repro_torch.core import store as store_lib


def rolled_back_tick(lm, params, tok, cache):
    # A rollback snapshot that shares storage with the live cache: the
    # decode step writes its K/V and SSM states into the same tensors.
    snap = {"cache": cache, "position": cache.position}
    logits, cache = lm.decode_step(params, tok, cache)
    if not bool(torch.isfinite(logits).all()):
        return snap["cache"]  # the post-step state, not the snapshot
    return cache


def old_layer_keys(lm, params, tok, cache):
    old_k = cache.k
    logits, cache = lm.decode_step(params, tok, cache)
    return (cache.k - old_k).abs().max()  # zero: old_k *is* cache.k


def replaced_snapshot(lm, params, tok, cache):
    before = cache._replace(position=cache.position.clone())
    logits, cache = lm.decode_step(params, tok, cache)
    return before.k  # _replace kept every other tensor by reference


def store_checkpoint(cfg, store, values):
    saved = (store.tables, store.lengths)
    store = store_lib.append(cfg, store, values)  # tables written in place
    return saved


def view_then_write(x, y):
    flat = x.view(-1)
    x.add_(y)
    return flat.sum()


def out_buffer(a, b, buf):
    prev = buf.detach()
    torch.mul(a, b, out=buf)
    return prev


def loop_carried(lm, params, toks, cache):
    for tok in toks:
        prev = cache
        logits, cache = lm.decode_step(params, tok, cache)
        yield prev.position  # stale on every iteration
