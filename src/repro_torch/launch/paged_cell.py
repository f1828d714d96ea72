"""The paged COW serve step as a cell: the paper's platform at scale (the
port of ``repro.launch.paged_cell``).

The regular decode cells use dense caches; this cell runs the *paged*
path: per-data-shard block pools (each shard owns its sequences' pages
with local block ids, the multi-device generalization of the serving
engine), block tables, and attention reading KV through the table with
the registry's ``paged_attention`` (the kernel on the card, the plain
version on the CPU; the reference calls its plain ``paged_attention_ref``
here).

Partitioning, as the reference's ``shard_map`` manual over the data axes
with the model axis automatic: the batch, the pools and the tables are
cut by hand over the data axes (block ids never cross shards, like the
per-thread contexts of the paper's Section 3) and :func:`body_local` runs
on one shard.  On the production mesh the weights are DTensors on the
model axis alone (TP, inference rules), so the body's layout over the
model axis is DTensor's; the cell traces there like a dry-run cell.  On
:func:`repro_torch.launch.mesh.make_host_mesh` (data only) every rank runs
the body on its own shard with whole weights.

Usage (after the standard sweep, on the host):
  PYTHONPATH=src python -m repro_torch.launch.paged_cell [arch] [single|multi]
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

__all__ = ["PagedCell", "body_local", "build", "main", "pool_blocks"]


def pool_blocks(b_local: int, n_blocks_per_seq: int) -> int:
    """Blocks a shard's pool holds: the sparse bound plus tails (the
    reference's ``paged_cell.py:47-53``), at most a dense pool's."""
    return min(
        b_local * n_blocks_per_seq,
        n_blocks_per_seq + int(2 * b_local * max(1.0, math.log(max(b_local, 2)))) + 2 * b_local,
    )


def body_local(cfg, params, pool, tables, lengths, tokens, *, block_size: int,
               attention: Optional[Callable] = None):
    """One decode step on one data shard (local block ids).

    pool [nb, L, 2, bs, KVH, hd]; tables [b, nb_seq] int32; lengths [b]
    int32 (the write position of each row's new token); tokens [b, 1].
    Each layer writes the new token's K/V into its row's page, in place,
    then attends through the tables with ``attention`` (the registry's
    ``paged_attention`` by default; its plain version for a check).
    Returns (logits [b, V], pool, lengths + 1)."""
    from repro_torch.distributed.sharding import write_slots
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import embed, mlp, rms_norm, torch_dtype, unembed
    from repro_torch.models.model import iter_layers

    attention = attention or paged_attention
    dt = torch_dtype(cfg.dtype)
    x = embed(params["embed"], tokens, dt)  # [b, 1, D]
    pos = lengths
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    bid = tables[rows, (pos // block_size).long()].long()
    slot = (pos % block_size).long()
    lengths_incl = lengths + 1
    for li, p in enumerate(iter_layers(params, cfg)):
        hn = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        q, k_new, v_new = attn_lib.qkv_proj(p["attn"], hn, cfg)
        q = attn_lib.apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = attn_lib.apply_rope(k_new, pos[:, None], cfg.rope_theta)
        write_slots(pool, (bid, li, 0, slot), k_new[:, 0].to(dt))
        write_slots(pool, (bid, li, 1, slot), v_new[:, 0].to(dt))
        out = attention(q[:, 0].contiguous(), pool[:, li, 0], pool[:, li, 1], tables, lengths_incl)
        x = x + attn_lib.out_proj(p["attn"], out[:, None])
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg.act)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params.get("unembed", params["embed"]), x)[:, 0]
    return logits, pool, lengths_incl


@dataclasses.dataclass
class PagedCell:
    cfg: Any
    mesh: Any
    step: Callable  # step(params, pool, tables, lengths, tokens) on the mesh's layout
    args: tuple  # meta stand-ins: params, pool, tables, lengths, tokens
    in_shardings: tuple
    b_local: int
    nb_local: int
    block_size: int
    fallbacks: list


def build(arch: str, mesh, batch: int = 128, seq: int = 32768, block_size: int = 128) -> PagedCell:
    """The paged cell of ``arch`` on ``mesh`` (the reference's ``build``):
    ``batch`` rows of up to ``seq`` positions, pages of ``block_size``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.distributed.sharding import PartitionSpec as P
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.model import LanguageModel

    cfg = get_config(arch).scaled(param_dtype="bfloat16")
    assert cfg.family in ("dense", "audio"), "paged cell: dense families"
    dp_axes = shd.data_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in dp_axes)
    assert batch % dp == 0
    b_local = batch // dp
    n_blocks_per_seq = seq // block_size
    nb_local = pool_blocks(b_local, n_blocks_per_seq)
    dt = torch_dtype(cfg.dtype)

    params, axes = LanguageModel(cfg).abstract_init()
    fallbacks: list = []
    param_sh = shd.shardings_for(mesh, shd.inference_rules(mesh), params, axes, report=fallbacks)
    meta = dict(device="meta")
    pool = torch.empty((nb_local * dp, cfg.n_layers, 2, block_size, cfg.n_kv_heads, cfg.hd), dtype=dt, **meta)
    tables = torch.empty((batch, n_blocks_per_seq), dtype=torch.int32, **meta)
    lengths = torch.empty((batch,), dtype=torch.int32, **meta)
    tokens = torch.empty((batch, 1), dtype=torch.int32, **meta)
    dspec = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    data_sh = NamedSharding(mesh, P(dspec))
    in_sh = (param_sh, data_sh, data_sh, data_sh, data_sh)
    model = "model" in shd.axis_names(mesh)

    def step(params, pool, tables, lengths, tokens):
        """Manual over the data axes: every rank runs :func:`body_local` on
        its shard; on a mesh with a model axis the weights become DTensors
        on that axis alone (their TP layout) and the shard's tensors are
        replicated on it."""
        if not isinstance(pool, DTensor):
            return body_local(cfg, params, pool, tables, lengths, tokens, block_size=block_size)
        from torch.distributed.tensor import Replicate

        names = shd.axis_names(mesh)
        if not model:
            local = [t.to_local() for t in (pool, tables, lengths, tokens)]
            whole = _map(lambda t: t.to_local() if isinstance(t, DTensor) else t, params)  # replicated
            logits, pool_l, lens = body_local(cfg, whole, *local, block_size=block_size)
            return tuple(_rewrap(t, mesh, len(names)) for t in (logits, pool_l, lens))
        sub = mesh["model"]
        mi = names.index("model")

        def on_model(t):
            return DTensor.from_local(t.to_local(), sub, (t.placements[mi],), run_check=False,
                                      shape=t.shape, stride=t.stride())

        local = [DTensor.from_local(t.to_local(), sub, (Replicate(),), run_check=False)
                 for t in (pool, tables, lengths, tokens)]
        with shd.activation_sharding(sub, mode="decode"):
            logits, pool_l, lens = body_local(cfg, _map(on_model, params), *local, block_size=block_size)
        return tuple(_rewrap(t, mesh, len(names), mi) for t in (logits, pool_l, lens))

    return PagedCell(cfg=cfg, mesh=mesh, step=step, args=(params, pool, tables, lengths, tokens),
                     in_shardings=in_sh, b_local=b_local, nb_local=nb_local, block_size=block_size,
                     fallbacks=fallbacks)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rewrap(t, mesh, ndim: int, model_dim: Optional[int] = None):
    """A shard's output (plain, or a DTensor on the model axis) as a
    DTensor on the whole mesh, its batch over the data axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pls = [Shard(0)] * ndim
    local = t
    if isinstance(t, DTensor):
        pls[model_dim] = t.placements[0]
        local = t.to_local()
    elif model_dim is not None:
        pls[model_dim] = Replicate()
    return DTensor.from_local(local, mesh, tuple(pls), run_check=False)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    arch = argv[0] if argv else "qwen25_32b"
    mesh_name = argv[1] if len(argv) > 1 else "single"

    from repro_torch.distributed.costs import traced_costs
    from repro_torch.launch.dryrun import RESULTS_DIR
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.roofline.analysis import analyze_traced

    multi = mesh_name == "multi"
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    cell = build(arch, mesh)
    t0 = time.time()
    costs = traced_costs(cell.step, cell.args, cell.in_shardings, mesh, mode="decode")
    out = {
        "arch": arch, "shape": "decode_32k_paged", "mesh": mesh_name, "n_chips": mesh.size(), "kind": "decode",
        "trace_s": round(time.time() - t0, 2), "b_local": cell.b_local, "nb_local": cell.nb_local,
        "sharding_fallbacks": sorted(set(cell.fallbacks)), "costs": costs, "ok": True,
    }
    rf = analyze_traced(costs, n_cards=mesh.size(), cfg=cell.cfg, kind="decode", batch=128, seq=32768)
    out["roofline"] = rf.as_dict()
    print(json.dumps({k: out[k] for k in ("arch", "shape", "mesh", "trace_s")}))
    print(f"roofline: compute={rf.compute_s:.4e}s memory={rf.memory_s:.4e}s "
          f"collective={rf.collective_s:.4e}s fraction={rf.roofline_fraction:.3f}")
    path = Path(RESULTS_DIR) / f"{arch}__decode_32k_paged__{mesh_name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
