"""Ranks of ``tests/test_torch_layout.py``'s gloo runs (no jax here):
``python torch_layout_ranks.py RANK WORLD DIR WHAT`` joins a gloo group of
WORLD ranks through a ``file://`` rendezvous in DIR and runs WHAT."""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402

SMOKE_ARCH, SMOKE_B, SMOKE_S = "starcoder2_3b", 4, 16


def smoke_inputs():
    """The smoke model, its weights and inputs (the same on every rank)."""
    from repro_torch.configs import smoke_config

    cfg = smoke_config(SMOKE_ARCH)
    lm = LanguageModel(cfg)
    params, axes = lm.init(torch.Generator().manual_seed(0), device="cpu"), lm.abstract_init()[1]
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SMOKE_B, SMOKE_S), generator=gen, dtype=torch.int32)
    step_tok = torch.randint(0, cfg.vocab_size, (SMOKE_B, 1), generator=gen, dtype=torch.int32)
    return cfg, lm, params, axes, tokens, step_tok


def sharded_step(rank: int, where: str) -> None:
    """The smoke forward (train rules) and a decode step (inference rules)
    on DTensor weights over a (2, 2) mesh, gathered; rank 0 saves them."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    cfg, lm, params, axes, tokens, step_tok = smoke_inputs()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    bspec = shd.placements(mesh, shd.PartitionSpec("data"))
    results = {}
    for mode, rules in (("train", shd.default_rules(mesh)), ("decode", shd.inference_rules(mesh))):
        sh = shd.shardings_for(mesh, rules, params, axes)
        dparams = shd._tree_map2(lambda p, s: distribute_tensor(p, mesh, s.placements), params, sh)
        with torch.no_grad(), shd.activation_sharding(mesh, mode):
            if mode == "train":
                results["forward"] = lm.forward(dparams, distribute_tensor(tokens, mesh, bspec)).full_tensor()
            else:
                _, cache = lm.prefill(params, tokens, SMOKE_S + 2)
                csh = steps.cache_shardings(mesh, cfg, cache)
                dcache = type(cache)(*(distribute_tensor(t, mesh, s.placements) for t, s in zip(cache, csh)))
                logits, dcache = lm.decode_step(dparams, distribute_tensor(step_tok, mesh, bspec), dcache)
                results["decode"] = logits.full_tensor()
                results["decode_k"] = dcache.k.full_tensor()
                results["decode_position"] = dcache.position.full_tensor()
    if rank == 0:
        torch.save(results, f"{where}/sharded.pt")


def elastic(rank: int, where: str) -> None:
    """Save a (2, 4)-sharded state; restore it onto (4, 2) with the axes
    swapped and onto (8,): each rank's shard and the whole tensor exact."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.train.checkpoint import Checkpointer

    P = shd.PartitionSpec
    want = torch.arange(64.0).reshape(8, 8)
    mesh_a = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    state = {"w": distribute_tensor(want, mesh_a, shd.placements(mesh_a, P("data", "model"))),
             "step": torch.tensor(3)}
    ck = Checkpointer(f"{where}/ck")
    ck.save(1, state)
    for shape, names, spec in (((4, 2), ("data", "model"), P("model", "data")), ((8,), ("data",), P("data"))):
        mesh_b = init_device_mesh("cpu", shape, mesh_dim_names=names)
        sh_b = {"w": shd.NamedSharding(mesh_b, spec), "step": shd.NamedSharding(mesh_b, P())}
        restored, step, _ = ck.restore({"w": want, "step": torch.tensor(0)}, device="cpu", placements=sh_b)
        w = restored["w"]
        assert step == 1 and tuple(w.placements) == sh_b["w"].placements, (w.placements, sh_b["w"].placements)
        assert torch.equal(w.full_tensor(), want)
        coord = mesh_b.get_coordinate()
        if len(shape) == 2:  # rows over "model" (mesh dim 1), columns over "data" (mesh dim 0)
            r, c = 8 // shape[1], 8 // shape[0]
            local = want[coord[1] * r:(coord[1] + 1) * r, coord[0] * c:(coord[0] + 1) * c]
        else:
            local = want[coord[0]:coord[0] + 1]
        assert torch.equal(w.to_local(), local), (rank, shape)
        assert int(restored["step"].full_tensor()) == 3


if __name__ == "__main__":
    rank, world, where, what = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"file://{where}/rendezvous", world_size=world, rank=rank)
    {"sharded_step": sharded_step, "elastic": elastic}[what](rank, where)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)
