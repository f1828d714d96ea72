"""The port's per-rank cost model, the paged cell and the dry run against
the JAX reference.

* **FLOPs.** The traced matmul FLOPs of starcoder2-3b's smoke prefill on
  one rank equal the reference's ``loop_aware_costs`` FLOPs of its
  forward within 1% (they read equal): the port's prefill fills its
  caches in the forward's own pass, while the reference's ``prefill``
  replays the forward for them, ~1.9x the FLOPs.  With the card's routing
  the attention is one ``repro_torch::flash_attention`` node priced by its
  formula.
* **Collective bytes.** A toy DTensor program on a fake (2, 4) group:
  one all-gather, one all-reduce and one reduce-scatter, each counted at
  its operand's bytes as ``hlo.py`` counts them, against hand counts.
* **The paged cell.** Its smoke-width local step (qwen2.5-32b's smoke
  config: a group of 5) equals the same composition of the reference's
  public functions (``paged_cell.py:88-117``: ``embed``, ``rms_norm``,
  ``qkv_proj``, ``apply_rope``, the pool writes, ``paged_attention_ref``,
  ``out_proj``, ``mlp``, ``unembed``): logits and the pool to 1e-5 of
  their largest magnitude.
* **Dry run and report.** One cell (mamba2-130m, decode_32k, single pod)
  end to end in a subprocess (the fake group is process-global), then
  ``repro_torch.roofline.report`` on its JSON.
* **The simulator's traced tick.** ``CostModel.from_traced`` prices a
  smoke engine's decode step from its trace.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.distributed.costs import graph_costs, trace_per_rank  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep * bool(env.get("PYTHONPATH")) + env.get("PYTHONPATH", "")
    return env


def meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_prefill_matmul_flops_match_reference():
    from repro.configs import smoke_config as j_smoke
    from repro.distributed.hlo import loop_aware_costs
    from repro.launch.steps import make_prefill_step as j_prefill
    from repro.models.model import LanguageModel as JLM

    b, s = 2, 64
    jlm = JLM(j_smoke("starcoder2_3b"))
    jparams, _ = jlm.abstract_init()
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    forward = loop_aware_costs(jax.jit(lambda p, t: jlm.forward(p, t)[:, -1]).lower(jparams, tok).compile().as_text())
    prefill = loop_aware_costs(jax.jit(j_prefill(jlm, s)).lower(jparams, {"tokens": tok}).compile().as_text())

    lm = LanguageModel(smoke_config("starcoder2_3b"))
    params, _ = lm.abstract_init()
    gm, _ = trace_per_rank(make_prefill_step(lm, s), (params, {"tokens": meta((b, s))}), None, None, card=False)
    gm.graph.eliminate_dead_code()
    costs = graph_costs(gm)
    assert abs(costs["matmul_flops"] / forward["flops"] - 1) < 0.01, (costs, forward["flops"])
    assert costs["kernel_flops"] == 0 and costs["collective_bytes"] == 0
    assert 1.5 < prefill["flops"] / costs["matmul_flops"] < 2.0  # the reference's replay

    # The card's program: each self-attention one flash node, by its formula.
    from repro_torch.kernels.flash_attention.ops import visible_pairs

    cfg = lm.cfg
    gm, _ = trace_per_rank(make_prefill_step(lm, s), (params, {"tokens": meta((b, s))}), None, None)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function" and "repro_torch.flash_attention" in str(n.target)]
    assert len(nodes) == cfg.n_layers
    card = graph_costs(gm)
    assert card["kernel_flops"] == cfg.n_layers * 4 * cfg.hd * b * cfg.n_heads * visible_pairs(s, s, 0)


COLLECTIVE_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.costs import graph_costs, trace_per_rank
    from repro_torch.distributed.sharding import NamedSharding, PartitionSpec as P
    from repro_torch.launch.mesh import fake_group
    from torch.distributed.device_mesh import init_device_mesh

    fake_group(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))

    def program(x, y):
        # x [8, 16] f32 over data: all-gathered (operand: a [4, 16] shard).
        whole = x.redistribute(mesh, (Replicate(), Replicate()))
        # y [8, 32] as a partial sum over model: all-reduced, and
        # reduce-scattered over model's 4 ranks (operand: [8, 32] each).
        part = DTensor.from_local(y.to_local() * 2, mesh, (Replicate(), Partial()), run_check=False)
        return whole, part.redistribute(mesh, (Replicate(), Replicate())), \\
            part.redistribute(mesh, (Replicate(), Shard(0)))

    args = (torch.empty((8, 16), device="meta"), torch.empty((8, 32), device="meta"))
    sh = (NamedSharding(mesh, P("data")), NamedSharding(mesh, P()))
    gm, _ = trace_per_rank(program, args, sh, mesh)
    print("COSTS " + json.dumps(graph_costs(gm)))
    """
)


def test_collective_bytes_match_hand_counts(tmp_path):
    script = tmp_path / "coll.py"
    script.write_text(COLLECTIVE_SCRIPT)
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=300,
                         env=subprocess_env(), cwd=str(ROOT))
    line = [x for x in out.stdout.splitlines() if x.startswith("COSTS ")]
    assert line, out.stderr[-3000:]
    costs = json.loads(line[0][6:])
    assert costs["collective_breakdown"] == {"all-gather": 4 * 16 * 4, "all-reduce": 8 * 32 * 4,
                                             "reduce-scatter": 8 * 32 * 4}, costs
    assert costs["collective_bytes"] == 256 + 1024 + 1024


def test_paged_cell_local_step_matches_reference():
    from repro.configs import smoke_config as j_smoke
    from repro.kernels.paged_attention.ref import paged_attention_ref as j_paged
    from repro.models import attention as j_attn
    from repro.models.layers import embed as j_embed
    from repro.models.layers import mlp as j_mlp
    from repro.models.layers import rms_norm as j_rms
    from repro.models.layers import unembed as j_unembed
    from repro.models.model import LanguageModel as JLM

    from repro_torch.launch import paged_cell

    arch, b, bs, nb_seq = "qwen25_32b", 4, 16, 4
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    assert cfg.n_heads // cfg.n_kv_heads == 5
    jparams, _ = JLM(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    nb = paged_cell.pool_blocks(b, nb_seq)
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((nb, cfg.n_layers, 2, bs, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    tables = np.full((b, nb_seq), -1, np.int32)
    tables[:, 0] = 0  # a shared first page
    tables[:, 1] = 1 + np.arange(b)  # a page each
    lengths = np.array([16, 20, 17, 31], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)

    # The reference's body (paged_cell.py:88-117), layer by layer.
    dt = jnp.dtype(jcfg.dtype)
    x = j_embed(jparams["embed"], jnp.asarray(tokens), dt)
    pos = jnp.asarray(lengths)
    bid = jnp.asarray(tables)[jnp.arange(b), pos // bs]
    slot = pos % bs
    jpool = jnp.asarray(pool)
    for li in range(jcfg.n_layers):
        p = jax.tree.map(lambda a: a[li], jparams["blocks"])
        hn = j_rms(x, p["ln1"]["scale"], jcfg.norm_eps)
        q, k_new, v_new = j_attn.qkv_proj(p["attn"], hn, jcfg)
        q = j_attn.apply_rope(q, pos[:, None], jcfg.rope_theta)
        k_new = j_attn.apply_rope(k_new, pos[:, None], jcfg.rope_theta)
        jpool = jpool.at[bid, li, 0, slot].set(k_new[:, 0].astype(dt))
        jpool = jpool.at[bid, li, 1, slot].set(v_new[:, 0].astype(dt))
        out = j_paged(q[:, 0], jpool[:, li, 0], jpool[:, li, 1], jnp.asarray(tables), pos + 1)
        x = x + j_attn.out_proj(p["attn"], out[:, None])
        x = x + j_mlp(p["mlp"], j_rms(x, p["ln2"]["scale"], jcfg.norm_eps), jcfg.act)
    x = j_rms(x, jparams["final_norm"]["scale"], jcfg.norm_eps)
    want = np.asarray(j_unembed(jparams.get("unembed", jparams["embed"]), x)[:, 0])

    tpool = torch.as_tensor(pool.copy())
    got, tpool, lens = paged_cell.body_local(cfg, params, tpool, torch.as_tensor(tables), torch.as_tensor(lengths),
                                             torch.as_tensor(tokens), block_size=bs)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(tpool.numpy() - np.asarray(jpool)).max() <= 1e-5 * np.abs(pool).max()
    assert lens.tolist() == (lengths + 1).tolist()


def test_dryrun_cell_and_report(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2_130m", "--shape", "decode_32k",
         "--mesh", "single", "--force", "--out", str(tmp_path / "dryrun_torch")],
        capture_output=True, text=True, timeout=600, env=subprocess_env(), cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    d = json.loads((tmp_path / "dryrun_torch" / "mamba2_130m__decode_32k__single.json").read_text())
    assert d["ok"] and d["n_chips"] == 256 and d["kind"] == "decode"
    costs, rf = d["costs"], d["roofline"]
    assert costs["flops"] > 0 and costs["bytes"] > 0 and costs["collective_bytes"] > 0
    assert rf["memory_s"] == costs["bytes"] / 3.35e12 and rf["dominant"] in ("compute", "memory", "collective")
    assert d["memory_analysis"]["estimated_argument_bytes_per_device"] > 0

    from repro_torch.roofline import report

    table = report.roofline_table("single", tmp_path / "dryrun_torch")
    assert "| mamba2_130m | decode_32k |" in table and "FAILED" not in table
    report.main(["--results", str(tmp_path / "dryrun_torch")])
    assert "mamba2_130m" in (tmp_path / "dryrun_torch_single.md").read_text()


def test_cost_model_prices_the_traced_tick():
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv_cache import KVCacheConfig
    from repro_torch.serving.sim import CostModel

    cfg = smoke_config("starcoder2_3b")
    lm = LanguageModel(cfg)
    ccfg = KVCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, block_size=16,
                         max_seqs=8, max_blocks_per_seq=8, num_blocks=64)
    engine = ServeEngine(lm, lm.init(torch.Generator().manual_seed(0), device="cpu"), ccfg, device="cpu")
    base = CostModel.from_roofline(cfg, ccfg)
    got = CostModel.from_traced(engine, base)
    assert got.step_s != base.step_s and got.step_s > 0
    assert (got.prefill_s, got.grow_s_per_block) == (base.prefill_s, base.grow_s_per_block)
