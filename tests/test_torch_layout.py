"""The port's model-parallel layout against the JAX reference: logical
axes on the parameters, the sharding rules and their fallbacks, the
activation constraints, ``build_cell``, a real sharded step and the
elastic checkpoint restore.

* **Axes.** Every arch's ``abstract_init()``: the same leaves, shapes,
  dtypes and logical axes as the reference's, bit for bit.
* **Specs.** Every parameter's spec and the fallback list under both rule
  sets on both production meshes (16 x 16, 2 x 16 x 16), against the
  reference's ``spec_for`` on a shape-only stand-in mesh, as
  ``tests/test_dryrun.py`` builds one.
* **Activation specs.** ``constrain``'s spec for a table of (shape, names,
  mode) cases against the reference's ``constrain``, read in one
  subprocess that fakes 512 host devices.
* **Cells.** ``build_cell`` for every (arch, shape) on the single-pod
  mesh against the reference's (its ``AbstractMesh``, its 14.0 GB budget
  passed as a ``Hardware``): every argument's shape and dtype, every
  sharding's spec (which shows the rule choice), the fallbacks,
  ``n_microbatches`` and ``estimated_argument_bytes_per_device``.
* **A real sharded step.** Four gloo ranks on a (2, 2) mesh run the
  smoke forward (train rules) and a decode step (inference rules) of
  starcoder2-3b's smoke config on DTensor weights: gathered, equal to the
  unsharded step within 1e-5 of the largest |logit| (sums in another
  order), the decode cache's written slots likewise.
* **Elastic restore.** Eight gloo ranks save a (2, 4)-sharded state and
  restore it onto (4, 2) with its axes swapped and onto (8,): each rank's
  shard and the gathered tensor equal the saved array (the reference's
  ``test_elastic_restore_across_meshes``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import shape_cells as j_shape_cells  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.dryrun import _estimate_arg_bytes as j_estimate  # noqa: E402
from repro.models.model import LanguageModel as JLM  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.costs import _leaves  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.dryrun import _estimate_arg_bytes  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.roofline.analysis import H100_SXM, Hardware, weight_budget_gb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
#: The reference's decode budget: a TPU v5e's 16 GB under its 14/16 headroom.
TPU_BUDGET = Hardware(name="tpu_v5e_budget", peak_flops=197e12, hbm_bw=819e9, nvlink_bw=50e9, hbm_bytes=16e9)


class FakeMesh:
    """Shape-only stand-in (enough for spec_for), as tests/test_dryrun.py's."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def norm_spec(spec) -> tuple:
    """A spec as a plain tuple: 1-tuples as their name, trailing Nones
    dropped (the reference's PartitionSpec and the port's alike)."""
    parts = [p[0] if isinstance(p, tuple) and len(p) == 1 else (tuple(p) if isinstance(p, tuple) else p)
             for p in tuple(spec)]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep * bool(env.get("PYTHONPATH")) + env.get("PYTHONPATH", "")
    return env


def test_archs_agree():
    assert list(ARCHS) == list(J_ARCHS)


# ---------------------------------------------------------------------------
# logical axes and parameter specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_init_matches_reference(arch):
    params, axes = LanguageModel(get_config(arch)).abstract_init()
    jparams, jaxes = JLM(j_get_config(arch)).abstract_init()
    p, a = flat(params), flat(axes)
    jp = flat(jparams)
    ja = {k: v for k, v in jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    ja = {"/".join(str(getattr(e, "key", e)) for e in path): v for path, v in ja.items()}
    assert set(p) == set(jp) == set(a) == set(ja)
    for k, t in p.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(jp[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(jp[k].dtype), k
        assert a[k] == tuple(ja[k]), k
        if k.startswith("blocks/"):
            assert a[k][0] == "layers", k


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rules", ["default", "inference"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_and_fallbacks_match_reference(arch, rules, mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    params, axes = LanguageModel(get_config(arch)).abstract_init()
    jparams, jaxes = JLM(j_get_config(arch)).abstract_init()
    port_rules = getattr(shd, f"{rules}_rules")(mesh)
    ref_rules = getattr(jshd, f"{rules}_rules")(mesh)
    assert port_rules.rules == ref_rules.rules
    a, ja = flat(axes), {}
    for path, v in jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]:
        ja["/".join(str(getattr(e, "key", e)) for e in path)] = v
    fb, jfb = [], []
    for k, t in sorted(flat(params).items()):
        spec = shd.spec_for(mesh, port_rules, t.shape, a[k], fallbacks=fb)
        jspec = jshd.spec_for(mesh, ref_rules, flat(jparams)[k].shape, ja[k], fallbacks=jfb)
        assert isinstance(spec, shd.PartitionSpec)
        assert tuple(spec) == tuple(jspec), (k, spec, jspec)
    assert fb == jfb


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    assert shd.placements(Mesh3, shd.PartitionSpec(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert shd.placements(Mesh3, shd.PartitionSpec(None, None, "data")) == (Replicate(), Shard(2), Replicate())
    assert shd.shard_count(FakeMesh(MESHES["multi"]), shd.PartitionSpec(("pod", "data"), "model")) == 512


def test_hooks_are_the_identity_without_a_mesh():
    x = torch.ones(4, 8)
    assert shd.constrain(x, ("act_batch", None)) is x
    assert shd.gather_weight(x, (None, "act_mlp")) is x
    assert shd.tp_size() == 1 and shd.sharding_mode() == "train"
    assert shd.ACT_RULES == jshd.ACT_RULES and shd._DECODE_ONLY == jshd._DECODE_ONLY


# ---------------------------------------------------------------------------
# activation specs, against the reference's constrain on 512 fake devices
# ---------------------------------------------------------------------------
ACT_CASES = [  # (shape, names, mode)
    ((32, 64, 8, 16), ("act_batch", "act_kv_seq", "act_kv_heads", None), "train"),
    ((32, 64, 2, 16), ("act_batch", "act_kv_seq", "act_kv_heads", None), "decode"),
    ((1, 64, 2, 16), ("act_batch", "act_kv_seq", "act_kv_heads", None), "decode"),
    ((48, 40, 128), (None, "act_heads", "act_head_dim"), "decode"),
    ((48, 40, 128), (None, "act_heads", "act_head_dim"), "train"),
    ((48, 32, 128), (None, "act_heads", "act_head_dim"), "decode"),
    ((24, 16, 48), ("act_experts", None, None), "train"),
    ((16, 48), (None, "act_mlp"), "train"),
    ((40, 16), ("act_mlp", None), "decode"),
    ((32, 8, 64), ("act_batch", None, "act_vocab"), "train"),
    ((8, 8, 64), ("act_batch", None, None), "decode"),
    ((32, 24, 2, 16), ("act_batch", None, "act_heads", None), "train"),
    ((0, 16), ("act_batch", None), "train"),
    ((64, 32), ("act_seq", "act_mlp"), "train"),
]

ACT_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.distributed.sharding import activation_sharding, constrain

    cases = json.loads(sys.argv[1])
    devs = np.array(jax.devices())
    meshes = {"single": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
              "multi": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}
    out = {}
    for name, mesh in meshes.items():
        for i, (shape, names, mode) in enumerate(cases):
            with activation_sharding(mesh, mode):
                y = constrain(jnp.zeros(tuple(shape), jnp.float32), tuple(names))
            out[f"{name}/{i}"] = [list(p) if isinstance(p, tuple) else p for p in y.sharding.spec]
    print("SPECS " + json.dumps(out))
    """
)


def test_activation_specs_match_reference(tmp_path):
    script = tmp_path / "act.py"
    script.write_text(ACT_SCRIPT)
    env = subprocess_env()
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(script), json.dumps(ACT_CASES)], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(ROOT))
    line = [x for x in out.stdout.splitlines() if x.startswith("SPECS ")]
    assert line, out.stderr[-2000:]
    ref = json.loads(line[0][6:])
    for name, sizes in MESHES.items():
        for i, (shape, names, mode) in enumerate(ACT_CASES):
            got = shd.activation_spec(FakeMesh(sizes), shape, names, mode)
            want = tuple(tuple(p) if isinstance(p, list) else p for p in ref[f"{name}/{i}"])
            assert norm_spec(got) == norm_spec(want), (name, shape, names, mode, got, want)


# ---------------------------------------------------------------------------
# build_cell against the reference's
# ---------------------------------------------------------------------------
def test_budget_is_the_reference_rule():
    assert weight_budget_gb(TPU_BUDGET) == 14.0
    assert weight_budget_gb(H100_SXM) == 70.0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_build_cell_matches_reference(arch):
    from jax.sharding import AbstractMesh

    jmesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = FakeMesh(MESHES["single"])
    from repro_torch.configs import shape_cells

    assert shape_cells(arch) == j_shape_cells(arch)
    for shape in j_shape_cells(arch):
        cell = steps.build_cell(arch, shape, mesh, hw=TPU_BUDGET)
        jcell = jsteps.build_cell(arch, shape, jmesh)
        assert cell.n_microbatches == jcell.n_microbatches, shape
        assert cell.fallbacks == jcell.fallbacks, shape
        assert cell.donate_argnums == jcell.donate_argnums, shape
        args, jargs = _leaves(cell.args), jax.tree.leaves(jcell.args)
        assert len(args) == len(jargs), shape
        for a, j in zip(args, jargs, strict=True):
            assert tuple(a.shape) == tuple(j.shape), shape
            assert str(a.dtype).removeprefix("torch.") == str(jnp.dtype(j.dtype)), shape
        sh = _leaves(cell.in_shardings)
        jsh = jax.tree.leaves(jcell.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        assert [norm_spec(s.spec) for s in sh] == [norm_spec(s.spec) for s in jsh], shape
        out, jout = _leaves(cell.out_shardings), jax.tree.leaves(
            jcell.out_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        assert [norm_spec(s.spec) for s in out] == [norm_spec(s.spec) for s in jout], shape
        assert _estimate_arg_bytes(cell.args, cell.in_shardings, mesh) == \
            j_estimate(jcell.args, jcell.in_shardings, jmesh), shape


# ---------------------------------------------------------------------------
# a real sharded step: four gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------
def run_ranks(tmp_path, world: int, what: str):
    """``world`` gloo ranks, a process each, meeting through a ``file://``
    rendezvous in ``tmp_path``, each running ``torch_layout_ranks``'s
    ``what``."""
    script = Path(__file__).resolve().parent / "torch_layout_ranks.py"
    env = subprocess_env()
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(tmp_path), what],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        logs.append((p.returncode, out, err[-3000:]))
    assert all(rc == 0 and "RANK_OK" in out for rc, out, _ in logs), logs


def test_sharded_step_on_a_gloo_mesh_equals_the_unsharded_step(tmp_path):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_layout_ranks import SMOKE_S, smoke_inputs

    run_ranks(tmp_path, 4, "sharded_step")
    got = torch.load(tmp_path / "sharded.pt")
    cfg, lm, params, axes, tokens, step_tok = smoke_inputs()
    with torch.no_grad():
        want = lm.forward(params, tokens)
        _, cache = lm.prefill(params, tokens, SMOKE_S + 2)
        logits, cache = lm.decode_step(params, step_tok, cache)
    for key, w in (("forward", want), ("decode", logits), ("decode_k", cache.k)):
        err = (got[key] - w).abs().max().item()
        assert err <= 1e-5 * w.abs().max().item(), (key, err)
    assert torch.equal(got["decode_position"], cache.position)


def test_elastic_restore_across_meshes(tmp_path):
    run_ranks(tmp_path, 8, "elastic")
