"""Plain PyTorch version of paged attention: gather blocks to dense K/V,
masked softmax attention.

The same function as ``repro.kernels.paged_attention.ref`` with one
difference: a row with no valid slot (length 0, or only NULL pages)
returns 0, as both TPU kernels' ``_finalize`` does (``l == 0`` divides
by 1).  The JAX oracle returns the mean of the gathered V there, a row
no caller reads.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(
    q: torch.Tensor,  # [B, H, d]
    k_pool: torch.Tensor,  # [num_blocks (+1), bs, KVH, d]
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # [B, nb] int32, -1 = NULL
    lengths: torch.Tensor,  # [B] int32
    *,
    parent: torch.Tensor | None = None,  # [num_blocks] int32 delta parents
    dirty: torch.Tensor | None = None,  # [num_blocks, bs] bool
    scale: float | None = None,
) -> torch.Tensor:
    b, h, d = q.shape
    nb = tables.shape[1]
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tab = tables.clamp(min=0).long()
    if parent is None:
        k = k_pool[tab].reshape(b, nb * bs, kvh, d)
        v = v_pool[tab].reshape(b, nb * bs, kvh, d)
    else:
        # Delta pages: dirty slots read the page, the rest its parent
        # (the page itself when it has none).
        par = parent[tab].long()
        res = torch.where(par >= 0, par, tab)
        sel = dirty[tab][..., None, None]  # [B, nb, bs, 1, 1]
        k = torch.where(sel, k_pool[tab], k_pool[res]).reshape(b, nb * bs, kvh, d)
        v = torch.where(sel, v_pool[tab], v_pool[res]).reshape(b, nb * bs, kvh, d)
    qg = q.reshape(b, kvh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(nb * bs, device=q.device)[None, :]
    ok = pos < lengths[:, None]
    ok = ok & torch.repeat_interleave(tables >= 0, bs, dim=1)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = torch.where(ok.any(dim=1)[:, None, None, None], out, 0.0)
    return out.reshape(b, h, d).to(q.dtype)
