"""Mamba2 SSD (state-space duality) mixer, in PyTorch (the port of
``repro.models.ssm``).

The prefill path (:func:`ssm_layer`) hands the chunked scan to the
registry's ``ssd_scan``: CUDA tensors launch ``csrc/ssd_scan.cu`` (on the
card P and N must be multiples of 16, or it raises; a chunk ``min(64, S)``
that is not runs over a ``dt = 0`` tail padded to one that is), CPU
tensors run the plain version, whose ``ssd_chunked`` is the
port's one copy of the reference's.  The scan takes ``x``, ``B`` and
``C`` in float32, as the reference casts them (``ssd_chunked`` casts
``x``; ``B``/``C`` go in as float32), so the card multiplies them as
TF32 on the tensor cores.

Single-token decode (:func:`ssm_decode`) carries ``(conv, state)`` and
costs O(1) a step; it is plain PyTorch, as the reference computes it
outside any kernel.  The reference's sharding hook (``gather_weight``)
is the identity on one device and is dropped.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import N_GROUPS
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, rms_norm

__all__ = ["N_GROUPS", "init_ssm", "ssm_layer", "SSMCache", "init_ssm_cache", "ssm_decode"]


def init_ssm(b, cfg: ModelConfig) -> None:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.n_ssm_heads
    conv_ch = di + 2 * N_GROUPS * n
    b.param("w_in_z", (d, di))
    b.param("w_in_x", (d, di))
    b.param("w_in_b", (d, N_GROUPS * n))
    b.param("w_in_c", (d, N_GROUPS * n))
    b.param("w_in_dt", (d, h))
    b.param("conv_w", (4, conv_ch), scale=0.5)
    b.param("conv_b", (conv_ch,), init="zeros")
    b.param("a_log", (h,), init="zeros")
    b.param("dt_bias", (h,), init="zeros")
    b.param("d_skip", (h,), init="ones")
    b.param("norm_scale", (di,), init="zeros")
    b.param("w_out", (di, d))


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4: x [B,S,C] -> [B,S,C]."""
    s = x.shape[1]
    out = w[3].to(x.dtype) * x
    for k in range(1, 4):
        out = out + w[3 - k].to(x.dtype) * F.pad(x, (0, 0, k, 0))[:, :s]
    return out + b.to(x.dtype)


class SSMCache(NamedTuple):
    conv: torch.Tensor  # [B, 3, conv_channels] last inputs
    state: torch.Tensor  # [B, H, P, N]


def _in_proj(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The conv's input channels ``[x, B, C]`` of x [..., D]."""
    dt_ = x.dtype
    return torch.cat(
        [x @ params["w_in_x"].to(dt_), x @ params["w_in_b"].to(dt_), x @ params["w_in_c"].to(dt_)],
        dim=-1,
    )


def _dt_and_a(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step sizes (post-softplus, f32) of x [..., D] and the decay rates
    ``a = -exp(a_log)`` [H], both from the f32 leaves."""
    dt = F.softplus((x @ params["w_in_dt"].to(x.dtype)).float() + params["dt_bias"].float())
    return dt, -torch.exp(params["a_log"].float())


def _out(params: Params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"].to(y.dtype)


def ssm_layer(
    params: Params, x: torch.Tensor, cfg: ModelConfig, chunk: int = 64
) -> Tuple[torch.Tensor, SSMCache]:
    """Training/prefill forward: x [B,S,D] -> (out [B,S,D], the decode
    cache after the last position).  The cache is the reference's
    ``_ssm_prefill_cache``: the last three conv inputs (zeros before the
    first) and the scan's final state, from the same scan as the output."""
    dt_ = x.dtype
    b, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z = x @ params["w_in_z"].to(dt_)
    xbc = _in_proj(params, x)
    conv_tail = F.pad(xbc[:, -3:], (0, 0, max(0, 3 - s), 0))
    act = F.silu(_conv1d(xbc, params["conv_w"], params["conv_b"]))
    xs = act[..., :di].reshape(b, s, h, p)
    dt, a = _dt_and_a(params, x)
    y, h_last = ssd_scan(
        xs.float().contiguous(), dt, a,
        act[..., di : di + n].float().contiguous(), act[..., di + n :].float().contiguous(),
        chunk=chunk,
    )
    y = y + params["d_skip"].float()[None, None, :, None] * xs.float()
    out = _out(params, y.reshape(b, s, di).to(dt_), z, cfg)
    return out, SSMCache(conv=conv_tail, state=h_last)


def init_ssm_cache(
    cfg: ModelConfig, batch: int, dtype: torch.dtype, device: torch.device | str = "cuda"
) -> SSMCache:
    """Zeroed decode cache of one layer: conv inputs in ``dtype``, the state
    in float32, on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    conv_ch = cfg.d_inner + 2 * N_GROUPS * cfg.ssm_state
    return SSMCache(
        conv=torch.zeros((batch, 3, conv_ch), dtype=dtype, device=dev),
        state=torch.zeros(
            (batch, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32, device=dev
        ),
    )


def ssm_decode(
    params: Params, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig
) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode: x [B,1,D]; O(1) state update."""
    dt_ = x.dtype
    b = x.shape[0]
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    z = x @ params["w_in_z"].to(dt_)
    window = torch.cat([cache.conv, _in_proj(params, x)], dim=1)  # [B,4,C]
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"].to(dt_)) + params["conv_b"].to(dt_)
    xbc = F.silu(conv_out)
    xs = xbc[..., :di].reshape(b, h, p).float()
    bmat = xbc[..., di : di + n].float()  # G = 1
    cmat = xbc[..., di + n :].float()
    dt, a = _dt_and_a(params, x[:, 0])  # [B,H]
    decay = torch.exp(dt * a)
    state = cache.state * decay[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xs, bmat)
    y = torch.einsum("bn,bhpn->bhp", cmat, state)
    y = y + params["d_skip"].float()[None, :, None] * xs
    out = _out(params, y.reshape(b, 1, di).to(dt_), z, cfg)
    return out, SSMCache(conv=window[:, 1:], state=state)
