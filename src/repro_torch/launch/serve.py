"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the COW-paged serving engine with batched requests: the reduced
(smoke) config by default, the full config with ``--full``, for any
architecture of :mod:`repro_torch.configs` (``--arch deepseek_moe_16b``,
``musicgen_large``, ...).  Weights are random, drawn from a seeded
``torch.Generator`` by the reference's law, each layer matrix cast to the
activation dtype as it is drawn.
``--smc`` switches to population-based decoding (N particles,
zero-copy resampling forks) through ``SMCDecoder``.  Runs on the card by
default; ``--device cpu`` runs the plain PyTorch path on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """Serve the batch; prints the timing and the first greedy tokens, and
    returns the continuations (``[batch, steps + 1]`` token ids, on the
    host).  With ``--smc``, decodes one population and returns its
    ``SMCDecodeResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--smc", action="store_true", help="population-based decoding")
    ap.add_argument("--particles", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving.engine import ServeEngine, draw_cast_params
    from repro_torch.serving.kv_cache import KVCacheConfig

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lm = LanguageModel(cfg)
    # Each layer matrix cast as soon as it is drawn: a model too large to
    # hold in float32 and in the activation dtype at once still fits.
    params = draw_cast_params(lm, gen, device=dev)
    max_len = args.prompt_len + args.steps + 16

    if args.smc:
        from repro_torch.serving.smc_decode import SMCDecoder

        dec = SMCDecoder(lm, params, n_particles=args.particles, max_len=max_len, device=dev)
        del params
        prompt = torch.randint(0, cfg.vocab_size, (args.prompt_len,), generator=gen, device=dev)
        t0 = time.time()
        res = dec.run(gen, prompt, steps=args.steps)
        dt = time.time() - t0
        if bool(res.oom):
            raise RuntimeError("a pool ran out of blocks: decoded tokens are not trustworthy")
        dense = dec.dense_equivalent_blocks(args.steps, args.prompt_len)
        peak = int(res.used_blocks_trace.max())
        print(f"SMC decode: {args.particles} particles x {args.steps} tokens "
              f"in {dt:.1f}s; {int(res.resampled.sum())} zero-copy forks; "
              f"peak {peak} KV blocks vs {dense} dense ({dense / peak:.2f}x)")
        return res

    # Independent prompts need a page each per block of context: size the
    # pool at the cap, not at the forked-population bound (which would
    # set the sticky oom flag and drop writes).
    cache_cfg = KVCacheConfig(
        n_layers=cfg.n_layers,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        max_seqs=args.batch,
        max_blocks_per_seq=-(-max_len // 16),
        dtype=cfg.dtype,
    )
    cache_cfg = dataclasses.replace(cache_cfg, num_blocks=cache_cfg.pool_blocks_cap)
    eng = ServeEngine(lm, params, cache_cfg, device=dev)
    del params
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen, device=dev
    )
    logits = eng.prefill(prompts, torch.arange(args.batch, dtype=torch.int32, device=dev))
    tok = torch.argmax(logits, -1)[:, None]
    outs = [tok]
    t0 = time.time()
    for _ in range(args.steps):
        logits = eng.decode(tok)
        tok = torch.argmax(logits, -1)[:, None]
        outs.append(tok)
    toks = torch.cat(outs, dim=1).cpu()
    dt = time.time() - t0
    if eng.oom:
        raise RuntimeError("the KV pool ran out of pages: decoded tokens are not trustworthy")
    print(
        f"served {args.batch} requests x {args.steps} tokens "
        f"in {dt:.1f}s ({dt / max(args.steps, 1) * 1e3:.0f} ms/step); "
        f"{eng.used_blocks} KV blocks live"
    )
    print("greedy continuations (first 12 tokens):")
    for row in toks[:, :12].tolist():
        print("  ", row)
    return toks


if __name__ == "__main__":
    main()
