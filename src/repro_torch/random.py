"""The port's one source of randomness.

Every draw in the port goes through :func:`uniform` or :func:`normal`
(:func:`gumbel` transforms :func:`uniform`'s draws).
``gen`` is a ``torch.Generator`` (on the device the draws should land
on), or any object with the same two methods — ``uniform(shape)`` and
``normal(shape)`` returning float32 tensors — such as :class:`Replay`,
through which the tests feed the JAX reference's draws to the port.

The filter draws in the same order in every copy mode (init normals;
then per generation the resampling uniforms, the propagation normals
and any alive-filter redraws), so one seed gives one ``log_evidence``
whatever the storage strategy.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "generator",
    "uniform",
    "normal",
    "gumbel",
    "Replay",
    "snapshot",
    "state",
    "from_state",
]


def generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def uniform(gen: Any, shape: Sequence[int]) -> torch.Tensor:
    """Float32 uniforms in ``[0, 1)`` of ``shape``."""
    if isinstance(gen, torch.Generator):
        return torch.rand(
            tuple(shape), generator=gen, device=gen.device, dtype=torch.float32
        )
    return gen.uniform(tuple(shape))


def normal(gen: Any, shape: Sequence[int]) -> torch.Tensor:
    """Float32 standard normals of ``shape``."""
    if isinstance(gen, torch.Generator):
        return torch.randn(
            tuple(shape), generator=gen, device=gen.device, dtype=torch.float32
        )
    return gen.normal(tuple(shape))


def gumbel(gen: Any, shape: Sequence[int]) -> torch.Tensor:
    """Float32 standard Gumbel noise of ``shape``: ``-log(-log(u))`` on
    :func:`uniform`'s draws clamped below at float32's ``tiny``.  This is
    the noise ``jax.random.categorical`` adds to the logits
    (``jax._src.random._gumbel``, mode "low", whose uniforms are drawn on
    ``[tiny, 1)``), so a :class:`Replay` of those uniforms gives its
    samples."""
    u = uniform(gen, shape).clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class Replay:
    """Recorded draws handed out in order: ``draws`` is a sequence of
    ``("uniform" | "normal", array)`` pairs, each returned (as float32 on
    ``device``) by the call of that kind and shape that comes next.  A
    call out of order raises, so a replayed run consumes exactly the
    recorded stream."""

    def __init__(self, draws: Sequence[Tuple[str, Any]], device: torch.device | str = "cpu"):
        self._draws = list(draws)
        self._next = 0
        self.device = torch.device(device)

    @property
    def remaining(self) -> int:
        return len(self._draws) - self._next

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return self._take("uniform", tuple(shape))

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return self._take("normal", tuple(shape))

    def clone(self) -> "Replay":
        copy = Replay(self._draws, self.device)
        copy._next = self._next
        return copy

    def _take(self, kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
        if self._next >= len(self._draws):
            raise IndexError(f"replay exhausted: asked for {kind}{shape}")
        want_kind, arr = self._draws[self._next]
        out = torch.as_tensor(np.array(arr, dtype=np.float32), device=self.device)
        if want_kind != kind or tuple(out.shape) != shape:
            raise ValueError(
                f"draw {self._next}: asked for {kind}{shape}, recorded "
                f"{want_kind}{tuple(out.shape)}"
            )
        self._next += 1
        return out


def snapshot(gen: Any) -> Any:
    """An independent copy of ``gen`` at its current position, so a
    rolled-back chunk can replay the same draws (the JAX reference gets
    this for free by carrying an immutable key).  Replay objects provide
    ``clone()``."""
    if isinstance(gen, torch.Generator):
        copy = torch.Generator(device=gen.device)
        copy.set_state(gen.get_state())
        return copy
    return gen.clone()


def state(gen: Any) -> Any:
    """A picklable record of ``gen``'s position (for checkpoints): a
    generator's device and ``get_state()`` bytes, or a copy of a replay."""
    if isinstance(gen, torch.Generator):
        return ("generator", str(gen.device), gen.get_state().numpy().copy())
    return ("replay", gen.clone())


def from_state(record: Any) -> Any:
    """The generator (or replay) :func:`state` recorded, at its position."""
    kind, *rest = record
    if kind == "generator":
        device, bits = rest
        gen = torch.Generator(device=torch.device(device))
        gen.set_state(torch.as_tensor(bits, dtype=torch.uint8))
        return gen
    return rest[0].clone()
