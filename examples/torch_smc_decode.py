"""Population-based LM decoding on the COW-paged KV cache, in PyTorch (the
port's counterpart of ``examples/smc_decode.py``).

A small decoder LM serves a *population* of N continuations; resampling
forks KV lineages with zero copying (refcount bookkeeping only); appends
copy-on-write one tail page per diverging lineage.  Runs on the GPU
unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch_smc_decode.py [--particles 32] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.model import LanguageModel
from repro_torch.serving.smc_decode import SMCDecoder

ap = argparse.ArgumentParser()
ap.add_argument("--particles", type=int, default=32)
ap.add_argument("--steps", type=int, default=48)
ap.add_argument("--prompt-len", type=int, default=12)
ap.add_argument("--target-temp", type=float, default=0.5)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

dev = resolve_device(args.device)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
cfg = smoke_config("starcoder2_3b")  # small decoder backbone
lm = LanguageModel(cfg)
params = lm.init(gen, device=dev)

print(f"model: {cfg.name} (reduced) — {cfg.n_layers}L d{cfg.d_model}")
print(f"population: {args.particles} particles, {args.steps} tokens, "
      f"target temperature {args.target_temp}")

dec = SMCDecoder(
    lm, params,
    n_particles=args.particles,
    max_len=args.prompt_len + args.steps + 16,
    target_temp=args.target_temp,
    block_size=4,
    device=dev,
)
prompt = torch.randint(0, cfg.vocab_size, (args.prompt_len,), generator=gen, device=dev)

t0 = time.time()
res = dec.run(gen, prompt, steps=args.steps)
dt = time.time() - t0

dense = dec.dense_equivalent_blocks(args.steps, args.prompt_len)
peak = int(res.used_blocks_trace.max())
print(f"\ndecoded {args.particles}x{args.steps} tokens in {dt:.1f}s "
      f"({dt / args.steps * 1e3:.0f} ms/step incl. kernel builds)")
print(f"resampling events: {int(res.resampled.sum())} "
      f"(each forked {args.particles} KV lineages with ZERO copying)")
print(f"peak KV blocks:    {peak}  vs dense per-sequence caches: {dense} "
      f"({dense / peak:.2f}x saving)")
print(f"log evidence:      {float(res.log_evidence):.2f}")
print(f"final ESS:         {float(res.ess_trace[-1]):.1f} / {args.particles}")
best = int(torch.argmax(res.log_weights))
print(f"best continuation: {res.tokens[best].cpu().numpy()[:16]} ...")
