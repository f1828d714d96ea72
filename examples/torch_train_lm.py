"""End-to-end training driver example, in PyTorch (the port's counterpart
of ``examples/train_lm.py``).

Trains an architecture's model on the synthetic Markov corpus with the
whole training path: token pipeline -> train step (loss, gradients through
the flash-attention and SSD backward kernels on the card, clipping,
AdamW) -> async checkpoints -> crash-idempotent resume.

Default: the reduced mamba2 config on the CPU for 300 steps; the loss
falls toward the corpus's entropy floor in a few minutes.  ``--device
cuda --full`` trains the real 130M-parameter config on the card, with
the corpus drawn from 4,096 of its 50,280 tokens (``--data-vocab``: the
chain's transition matrix is vocabulary-squared).

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cuda --full]
Resume after a crash: run the same command again.
"""

import argparse

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, Trainer

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="mamba2_130m")
ap.add_argument("--full", action="store_true")
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq-len", type=int, default=128)
ap.add_argument("--device", default="cpu")
ap.add_argument("--data-vocab", type=int, default=None)
args = ap.parse_args()

model_cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
data_cfg = DataConfig(
    vocab_size=args.data_vocab or min(model_cfg.vocab_size, 4096), seq_len=args.seq_len,
    global_batch=args.batch,
)
trainer = Trainer(
    model_cfg,
    data_cfg,
    AdamWConfig(learning_rate=3e-3, warmup_steps=20, total_steps=args.steps),
    TrainConfig(
        total_steps=args.steps,
        log_every=20,
        checkpoint_every=100,
        checkpoint_dir=f"checkpoints/torch_example_{args.arch}",
    ),
    device=args.device,
)
history = trainer.run()
floor = trainer.data.entropy_rate
print(f"\nloss {history['loss'][0]:.3f} -> {history['loss'][-1]:.3f} "
      f"(corpus entropy floor {floor:.3f} nats/token)")
