#!/usr/bin/env python3
"""Read-only checks, on the host's CPU, of where the paper's programs in
the port and in the JAX reference part in float32, and of CRBD's alive
loop on the port's own data.

1. ``pieces``: one piece of a program's arithmetic at a time, computed by
   the jitted reference (parameters passed as arguments, as the filter
   passes them) and by the port on the same float32 inputs (4,096 of
   them, drawn with numpy from a fixed seed); for each, the count of
   elements whose bits differ, for the port's form and for the plain
   PyTorch form it replaced:
   * RBPF's ``einsum("i,nij,j->n", c, P, c)`` (the port: a fused
     multiply-add chain, ``torch.addcmul``);
   * VBD's ``1 - exp(-beta * I / N)`` at its arguments (~1e-3; the port:
     the reciprocal multiply and ``exp`` taken in float64);
   * MOT's uniform on ``[-20, 20)`` from ``jax.random.uniform``'s own
     uniforms (the port: ``torch.add`` with ``alpha``, one fused
     multiply-add) and ``c * normal`` against a replayed normal times
     ``c`` (the reference folds ``c`` into its sampler's ``sqrt(2)``; no
     form of the port reproduces it).
2. ``crbd``: the smallest and the mean ESS of CRBD's alive filter with
   0 and 8 retries (N = 64, T = 40, data and filter seeds 0-11, the
   port's own ``gen_data``).

Run from the repository root: ``python3 scripts/torch_program_float_checks.py``
(~30 s).  Prints one JSON object.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.smc.programs import vbd as jvbd  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter  # noqa: E402
from repro_torch.smc.programs import crbd, rbpf, vbd  # noqa: E402

N = 4096


def differ(a, b) -> int:
    return int((np.asarray(a) != np.asarray(b)).sum())


def pieces() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    # RBPF: c^T P c.
    p = rng.standard_normal((N, 2, 2)).astype(np.float32)
    c = np.asarray(rbpf._C, np.float32)
    want = jax.jit(lambda p, c: jnp.einsum("i,nij,j->n", c, p, c))(p, c)
    k = rbpf._consts(torch.device("cpu"))
    tp, tc = torch.as_tensor(p), torch.as_tensor(c)
    out["rbpf_cPc"] = {"port": differ(rbpf._quad(tp, k.cc), want),
                       "einsum": differ(torch.einsum("i,nij,j->n", tc, tp, tc), want)}
    # VBD: the force of infection at its arguments.
    im = (rng.random(N) * 50).astype(np.float32)
    beta = np.float32(0.35)
    want = jax.jit(lambda b, x: 1 - jnp.exp(-b * x / jvbd.N_M))(beta, im)
    tb, ti = torch.tensor(beta), torch.as_tensor(im)
    port = 1 - torch.exp((-tb * ti * (1 / vbd.N_M)).double()).float()
    plain = 1 - torch.exp(-tb * ti / vbd.N_M)
    out["vbd_force_of_infection"] = {"port": differ(port, want), "plain": differ(plain, want)}
    # MOT: a uniform on [lo, hi), and c * normal.
    key = jax.random.PRNGKey(0)
    want = jax.random.uniform(key, (N,), minval=-20.0, maxval=20.0)
    u = torch.as_tensor(np.array(jax.random.uniform(key, (N,))))
    fused = torch.clamp(torch.add(torch.full_like(u, -20.0), u, alpha=40.0), min=-20.0)
    out["mot_uniform"] = {"port": differ(fused, want), "plain": differ(torch.clamp(u * 40.0 - 20.0, min=-20.0), want)}
    scale = math.sqrt(0.05)
    want = jax.jit(lambda k: scale * jax.random.normal(k, (N,)))(key)
    z = torch.as_tensor(np.array(jax.random.normal(key, (N,))))
    out["mot_scaled_normal"] = {"port": differ(scale * z, want)}
    return out


def crbd_retries() -> dict:
    ssm, _ = crbd.build()
    runs = []
    for seed in range(12):
        obs = crbd.gen_data(rnd.generator(seed, "cpu"), 40)
        ess = {}
        for retries in (0, 8):
            cfg = FilterConfig(n_particles=64, n_steps=40, max_retries=retries)
            res = ParticleFilter(ssm, cfg, device="cpu").run(rnd.generator(seed, "cpu"), None, obs)
            ess[retries] = (float(res.ess_trace.min()), float(res.ess_trace.mean()))
        runs.append({"seed": seed, "min_ess": [ess[0][0], ess[8][0]], "mean_ess": [ess[0][1], ess[8][1]]})
    return {"runs": runs,
            "min_rose": sum(r["min_ess"][1] >= r["min_ess"][0] for r in runs),
            "mean_rose": sum(r["mean_ess"][1] > r["mean_ess"][0] for r in runs)}


def main() -> int:
    print(json.dumps({"elements": N, "pieces": pieces(), "crbd": crbd_retries()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
