"""The model-path kernels as ``torch.library`` custom ops, PyTorch's idiom
for a hand-written kernel (as an XLA custom call is for a Pallas one).

Each op's package registers its ops (namespace ``repro_torch``) at the
foot of its ``ops.py``: a CUDA implementation that calls the launch
wrapper (its ``launches`` counter is the wrapper's), a CPU
implementation that calls ``ref.py``, a fake implementation that gives
the output shapes (so a ``FakeTensorMode`` trace runs nothing, and no
``data_ptr`` is read), a FLOP formula for ``torch.utils.flop_counter``
and, through :func:`shardings`, the layouts a DTensor call may take
(``torch.distributed.tensor.experimental.register_sharding``).  The
device policy stays ``kernels/dispatch.py``'s: the CUDA implementation
launches or raises, the CPU one runs the plain version, and any other
device has no implementation.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["shardings"]


def shardings(op) -> Callable:
    """Decorator: register ``fn(*args) -> [(output placements, input
    placements), ...]`` as ``op``'s DTensor strategies, where
    ``torch.distributed`` is built in."""
    def register(fn: Callable) -> Callable:
        if torch.distributed.is_available():
            from torch.distributed.tensor.experimental import register_sharding

            register_sharding(op)(fn)
        return fn

    return register


def replicate_all(n_out: int, n_in: int, tensor_in: tuple) -> tuple:
    """The all-replicated strategy: ``tensor_in`` marks which inputs are
    tensors (the others take ``None``)."""
    from torch.distributed.tensor import Replicate

    return ([Replicate()] * n_out, [Replicate() if t else None for t in tensor_in])
