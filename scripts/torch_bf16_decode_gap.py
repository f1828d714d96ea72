#!/usr/bin/env python3
"""Read-only check, on the host's CPU, of how far bf16 decoding drifts from
the teacher-forced forward, in the port and in the JAX reference, on the
same weights and tokens.

For each model: the reference's ``init`` from ``PRNGKey(0)`` (float32
leaves), carried into the port by ``convert.params_from_numpy``; the config
at bf16 activations; tokens from numpy's seed 21.  Both packages run
``forward`` over prompt + steps tokens, ``prefill`` of the prompt and
``decode_step`` on the fed tokens.  Printed per model, in units of a step's
largest |logit|:

* ``port_vs_reference``: the worst gap between the two packages' decode
  logits (and their prefill's);
* ``reference_gap`` and ``port_gap``: each package's worst gap between a
  decode step's logits and its own forward's at that position, and the
  share of steps where the two argmaxes agree.

Models: the smoke configs of mamba2-130m and zamba2-7b (prompt 13, three
steps, the sizes of ``tests/test_torch_families.py``); with ``--full``,
also mamba2-130m at its published widths (prompt 256, 64 steps; ~2.5 min
in all on 8 cores).

Run from the repository root: ``python3 scripts/torch_bf16_decode_gap.py
[--full]``.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402


def gaps(arch: str, full: bool, batch: int, prompt: int, steps: int) -> dict:
    cfg = (configs.get_config if full else configs.smoke_config)(arch).scaled(dtype="bfloat16")
    jcfg = (jget_config if full else jsmoke_config)(arch).scaled(dtype="bfloat16")
    jlm, lm = JLanguageModel(jcfg), LanguageModel(cfg)
    jparams, _ = jlm.init(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(21).integers(0, cfg.vocab_size, (batch, prompt + steps)).astype(np.int32)
    with torch.no_grad():
        jfull = np.asarray(jax.jit(jlm.forward)(jparams, jnp.asarray(tokens), None), np.float32)
        tfull = lm.forward(tparams, torch.as_tensor(tokens)).float().numpy()
        jlog, jcache = jax.jit(jlm.prefill, static_argnums=2)(
            jparams, jnp.asarray(tokens[:, :prompt]), prompt + steps, None)
        tlog, tcache = lm.prefill(tparams, torch.as_tensor(tokens[:, :prompt]), prompt + steps)
        jlog, tlog = np.asarray(jlog, np.float32), tlog.float().numpy()
        out = {"shape": [batch, prompt, steps], "prefill_port_vs_reference":
               float(np.abs(tlog - jlog).max() / np.abs(jlog).max()), "port_vs_reference": 0.0,
               "reference_gap": 0.0, "port_gap": 0.0, "reference_agreement": 0.0, "port_agreement": 0.0}
        step = jax.jit(jlm.decode_step)
        for i in range(steps):
            tok = tokens[:, prompt + i : prompt + i + 1]
            jlog, jcache = step(jparams, jnp.asarray(tok), jcache)
            tlog, tcache = lm.decode_step(tparams, torch.as_tensor(tok), tcache)
            jlog, tlog = np.asarray(jlog, np.float32), tlog.float().numpy()
            jf, tf = jfull[:, prompt + i], tfull[:, prompt + i]
            out["port_vs_reference"] = max(out["port_vs_reference"], float(np.abs(tlog - jlog).max() / np.abs(jlog).max()))
            out["reference_gap"] = max(out["reference_gap"], float(np.abs(jlog - jf).max() / np.abs(jf).max()))
            out["port_gap"] = max(out["port_gap"], float(np.abs(tlog - tf).max() / np.abs(tf).max()))
            out["reference_agreement"] += float((jlog.argmax(-1) == jf.argmax(-1)).mean()) / steps
            out["port_agreement"] += float((tlog.argmax(-1) == tf.argmax(-1)).mean()) / steps
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="also mamba2-130m at its published widths")
    args = ap.parse_args()
    report = {f"{arch} smoke": gaps(arch, False, 2, 13, 3) for arch in ("mamba2_130m", "zamba2_7b")}
    if args.full:
        report["mamba2_130m full"] = gaps("mamba2_130m", True, 2, 256, 64)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
