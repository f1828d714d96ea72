"""Particle Gibbs on the VBD model, in PyTorch (the port's counterpart of
``examples/particle_gibbs.py``) — the paper's eager-copy case.

The retained reference trajectory is deep-copied *eagerly* between
iterations (it must outlive the population — outside the tree pattern),
exactly the note in the paper's Section 4 for its VBD experiment.  Runs
on the GPU unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_particle_gibbs.py [--device cpu]
"""

import argparse
import time

from repro_torch import random as rnd
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.smc import FilterConfig, ParticleGibbs
from repro_torch.smc.programs import vbd

ap = argparse.ArgumentParser()
ap.add_argument("--particles", type=int, default=256)
ap.add_argument("--steps", type=int, default=60)
ap.add_argument("--iters", type=int, default=3)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
T, N, ITERS = args.steps, args.particles, args.iters

dev = resolve_device(args.device)
ssm, _ = vbd.build()
params = vbd.default_params(dev)
obs = vbd.gen_data(rnd.generator(0, dev), T)
print(f"VBD (SEIR/SEI) dengue-style outbreak: T={T} weeks of case counts")
print(f"particle Gibbs: N={N}, {ITERS} iterations "
      f"(paper: N={vbd.PAPER_N}, T={vbd.PAPER_T}, {vbd.PG_ITERS} iterations)")

pg = ParticleGibbs(ssm, FilterConfig(n_particles=N, n_steps=T), device=dev)
t0 = time.time()
out = pg.run(rnd.generator(1, dev), params, obs, n_iters=ITERS)
print(f"\nran in {time.time() - t0:.1f}s on {dev} (kernel builds included on a GPU)")
print(f"log-evidence per iteration: {[f'{z:.1f}' for z in out.log_evidences.tolist()]}")
print(f"peak store blocks: {int(out.peak_blocks)} (dense equivalent {N * T // 4}); oom={bool(out.oom)}")
ref = out.reference.cpu()
print(f"retained trajectory (eagerly copied): shape {tuple(ref.shape)}")
print(f"final infected (Ih) along the reference: {ref[:: T // 6, 2].round(decimals=1).tolist()}")
