"""Shared neural-net layers, in PyTorch (the port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors with the reference's tree
and names.  Initialisation goes through :class:`ParamBuilder`, which
draws from an explicit ``torch.Generator`` by the reference's law
(``layers.py:47-72`` of the JAX package): normal with standard deviation
``1/sqrt(shape[0])`` (or the given ``scale``), norm scales zero, the
SSM's skip gains one.  The two
frameworks give different numbers from one seed, so tests start both
sides from the same weights through :mod:`repro_torch.convert`.  Each
parameter carries the reference's *logical axis names* per dimension
("embed", "heads", "mlp", "vocab", "experts", "layers", ...), recorded
in a tree beside the parameters; :mod:`repro_torch.distributed.sharding`
maps them onto mesh axes, as the reference's sharding layer does.  The
model code calls that module's ``gather_weight`` on each weight it
reads, the identity outside ``activation_sharding``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import gather_weight, matmul, sharded_embed

Params = Dict[str, Any]
Axes = Dict[str, Any]

__all__ = [
    "Axes",
    "Params",
    "ParamBuilder",
    "stack_layer_params",
    "rms_norm",
    "init_rms_norm",
    "act_fn",
    "init_mlp",
    "mlp",
    "init_embedding",
    "embed",
    "unembed",
    "rope_frequencies",
    "apply_rope",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, ...)."""
    return _DTYPES[name]


def _set(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


class ParamBuilder:
    """Draws parameters during init and records their logical axes.

    ``layers > 0`` gives every leaf a leading layer axis of that size
    (the stacked ``blocks`` tree that the layer loop indexes) and its
    axes a leading ``"layers"``; the law is that of the per-layer shape.
    With ``generator=None`` nothing is drawn or allocated: the leaves are
    ``meta`` tensors of the parameter dtype, and ``specs`` holds each
    path's shape (the reference's ``abstract=True``).  ``finish``,
    if given, maps each leaf as soon as it is drawn (``finish(path,
    value)``), before the next one is: a cast there keeps one leaf in
    the parameter dtype at a time.
    """

    def __init__(
        self,
        generator: Optional[torch.Generator],
        param_dtype: str = "float32",
        *,
        device: torch.device | str = "cpu",
        layers: int = 0,
        finish: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
    ):
        self.gen = generator
        self.dtype = torch_dtype(param_dtype)
        self.device = torch.device(device)
        self.layers = layers
        self.finish = finish
        self.params: Params = {}
        self.axes: Axes = {}
        self.specs: Dict[str, Tuple[int, ...]] = {}

    def param(
        self,
        path: str,
        shape: Sequence[int],
        axes: Sequence[Optional[str]],
        init: str = "normal",
        scale: float | None = None,
    ) -> torch.Tensor:
        shape = tuple(shape)
        assert len(shape) == len(axes), (path, shape, axes)
        full = ((self.layers,) if self.layers else ()) + shape
        self.specs[path] = full
        _set(self.axes, path, (("layers",) if self.layers else ()) + tuple(axes))
        if self.gen is None:
            value = torch.empty(full, dtype=self.dtype, device="meta")
            _set(self.params, path, value)
            return value
        if init == "zeros":
            value = torch.zeros(full, dtype=self.dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(full, dtype=self.dtype, device=self.device)
        elif init == "normal":
            fan_in = shape[0] if len(shape) > 1 else max(shape[-1], 1)
            std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            value = torch.randn(full, generator=self.gen, dtype=self.dtype, device=self.device)
            value.mul_(std)
        else:
            raise ValueError(init)
        if self.finish is not None:
            value = self.finish(path, value)
        _set(self.params, path, value)
        return value

    def scope(self, prefix: str) -> "ScopedBuilder":
        return ScopedBuilder(self, prefix)


class ScopedBuilder:
    def __init__(self, base: ParamBuilder, prefix: str):
        self.base = base
        self.prefix = prefix

    def param(self, path: str, *args, **kwargs) -> torch.Tensor:
        return self.base.param(f"{self.prefix}/{path}", *args, **kwargs)

    def scope(self, prefix: str) -> "ScopedBuilder":
        return ScopedBuilder(self.base, f"{self.prefix}/{prefix}")


def stack_layer_params(
    init_fn: Callable[[ParamBuilder], None],
    generator: Optional[torch.Generator],
    n_layers: int,
    param_dtype: str,
    *,
    device: torch.device | str = "cpu",
    finish: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
) -> ParamBuilder:
    """Initialise a layer stack: every leaf gets a leading layer axis of
    size ``n_layers`` (the reference vmaps one init over split keys; the
    law per layer is the same) and every leaf's axes a leading
    ``"layers"``.  Returns the builder (``.params``, ``.axes``,
    ``.specs``)."""
    b = ParamBuilder(generator, param_dtype, device=device, layers=n_layers, finish=finish)
    init_fn(b)
    return b


# ---------------------------------------------------------------------------
# functional layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm scaled by ``1 + weight``, computed in float32."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def init_rms_norm(b, path: str, dim: int) -> None:
    b.param(f"{path}/scale", (dim,), ("embed",), init="zeros")


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def init_mlp(b, path: str, d_model: int, d_ff: int, gated: bool = True) -> None:
    s = b.scope(path)
    if gated:
        s.param("w_gate", (d_model, d_ff), ("embed", "mlp"))
    s.param("w_up", (d_model, d_ff), ("embed", "mlp"))
    s.param("w_down", (d_ff, d_model), ("mlp", "embed"))


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = matmul(x, gather_weight(params["w_up"].to(x.dtype), (None, "act_mlp")))
    if "w_gate" in params:
        w_gate = gather_weight(params["w_gate"].to(x.dtype), (None, "act_mlp"))
        hidden = act_fn(act)(matmul(x, w_gate)) * up
    else:
        hidden = act_fn(act)(up)
    return matmul(hidden, gather_weight(params["w_down"].to(x.dtype), ("act_mlp", None)))


def init_embedding(b, path: str, vocab: int, d_model: int) -> None:
    b.param(path, (vocab, d_model), ("vocab", "embed"), scale=1.0)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # Gather then cast: the same values as the reference's cast-then-gather.
    if isinstance(table, DTensor):
        return sharded_embed(table, tokens).to(dtype)
    return table[tokens.long()].to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T, in float32 against the float32 table."""
    return matmul(x.float(), table.float().T)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Rotates the
    two halves of the head dimension (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
