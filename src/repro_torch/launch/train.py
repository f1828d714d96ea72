"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced (smoke) config of the chosen architecture against the
synthetic Markov corpus, or the full config with ``--full``, through
``Trainer``.  Runs on the card by default; ``--device cpu`` runs the
plain PyTorch path on the host.  Crash-idempotent: running the same
command again resumes from the latest checkpoint.  The flags are the
reference's, and ``--device``, ``--microbatches`` (equal slices of the
batch a step) and ``--data-vocab`` (the corpus's vocabulary, the
model's by default: the Markov chain's transition matrix is
vocabulary-squared, 20 GB of host memory at mamba2-130m's 50,280).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """Train; prints the log lines and the final loss, and returns the
    ``Trainer`` (its ``final_state`` and ``data``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="use the full (production) config instead of smoke")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-vocab", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, Trainer

    model_cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    data_cfg = DataConfig(
        vocab_size=args.data_vocab or model_cfg.vocab_size,
        seq_len=args.seq_len,
        global_batch=args.batch,
    )
    opt_cfg = AdamWConfig(learning_rate=args.lr, warmup_steps=20, total_steps=args.steps)
    train_cfg = TrainConfig(
        total_steps=args.steps,
        log_every=args.log_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=f"{args.checkpoint_dir}/{args.arch}",
        crash_at=args.crash_at,
        microbatches=args.microbatches,
    )
    trainer = Trainer(model_cfg, data_cfg, opt_cfg, train_cfg, device=args.device)
    history = trainer.run()
    print(f"final loss {history['loss'][-1]:.4f} (entropy floor {trainer.data.entropy_rate:.4f})")
    return trainer


if __name__ == "__main__":
    main()
