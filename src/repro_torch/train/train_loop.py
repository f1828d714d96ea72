"""The fault-tolerant training loop (the port of
``repro.train.train_loop``).

Composes the model, the optimizer, the token pipeline and the
checkpoints into a crash-idempotent trainer:

  * on start it resumes from the latest checkpoint (params, optimizer
    moments, data cursor): a preempted job relaunched with the same
    arguments continues where the checkpoint left it, since the pipeline
    is stateless given the step;
  * periodic ``save_async`` checkpoints keep the files off the step's
    path;
  * ``crash_at`` injects a failure, so a test can hold the resumed run to
    the uninterrupted one, step for step;
  * per-step work is a function of ``(state, step)``, so replacing a
    node is a restore and another world size re-slices the same global
    batch (``data/pipeline.py``).

Each step is the reference's: ``loss.backward`` of ``LanguageModel.loss``
against the f32 master weights (the forward casts each weight to the
compute dtype as it reads it), then ``adamw_update``.  With
``TrainConfig.microbatches > 1`` the global batch runs in that many equal
microbatches whose f32 gradients are averaged (the reference's trainer
takes the batch whole; ``launch/steps.py``'s step accumulates in the
communication dtype instead).  ``Trainer`` runs on the card unless the
caller asks for the CPU, and raises without one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LanguageModel
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map

__all__ = ["TrainConfig", "InjectedFailure", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    crash_at: Optional[int] = None  # failure injection (tests)
    seed: int = 0
    microbatches: int = 1  # equal slices of the global batch a step


class InjectedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        *,
        device: torch.device | str = "cuda",
    ):
        self.device = resolve_device(device)
        if data_cfg.global_batch % train_cfg.microbatches:
            raise ValueError(f"global batch {data_cfg.global_batch} is not a multiple of "
                             f"{train_cfg.microbatches} microbatches")
        self.model_cfg = model_cfg
        self.lm = LanguageModel(model_cfg)
        self.data = TokenPipeline(data_cfg, device=self.device)
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.ckpt = Checkpointer(train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints)

    def _train_step(self, params, opt_state, batch):
        n = self.cfg.microbatches
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        mb = batch["tokens"].shape[0] // n
        acc, losses, accuracy = None, [], []
        for i in range(n):
            rows = slice(i * mb, (i + 1) * mb)
            loss, metrics = self.lm.loss(params, batch["tokens"][rows], batch["labels"][rows])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g.float() for x, g in zip(leaves, grads, strict=True)]
            acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads, strict=True)]
            losses.append(loss.detach())
            accuracy.append(metrics["accuracy"].detach())
        for x in leaves:
            x.requires_grad_(False)
        if n > 1:
            acc = [a / n for a in acc]
        it = iter(acc)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(self.opt_cfg, params, grads, opt_state)
        metrics = {"loss": torch.stack(losses).mean(), "accuracy": torch.stack(accuracy).float().mean()}
        return params, opt_state, {**metrics, **om}

    # ------------------------------------------------------------------
    def init_or_restore(self):
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        params = self.lm.init(gen, device=self.device)
        opt_state = adamw_init(params)
        start = 0
        if self.ckpt.latest_step() is not None:
            (params, opt_state), start, _ = self.ckpt.restore((params, opt_state), device=self.device)
        return params, opt_state, start

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict[str, List[float]]:
        params, opt_state, start = self.init_or_restore()
        history: Dict[str, List[float]] = {"step": [], "loss": [], "time": []}
        self.grad_norms: List[float] = []  # beside each logged step's loss
        for step in range(start, self.cfg.total_steps):
            if self.cfg.crash_at is not None and step == self.cfg.crash_at:
                # simulate preemption AFTER the last checkpoint: its files are
                # complete (the write in flight is waited for) before the raise
                self.ckpt.wait()
                raise InjectedFailure(f"injected failure at step {step}")
            self._sync()
            t0 = time.time()
            batch = self.data.batch(step)
            params, opt_state, metrics = self._train_step(params, opt_state, batch)
            self._sync()
            dt = time.time() - t0
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                history["step"].append(step)
                history["loss"].append(loss)
                history["time"].append(dt)
                self.grad_norms.append(float(metrics["grad_norm"]))
                print(
                    f"step {step + 1}/{self.cfg.total_steps} "
                    f"loss={loss:.4f} (floor~{self.data.entropy_rate:.3f}) "
                    f"grad_norm={self.grad_norms[-1]:.3f} {dt * 1000:.0f}ms"
                )
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save_async(step + 1, (params, opt_state), extra=self.data.state(step + 1))
        self.ckpt.wait()
        self.ckpt.save(self.cfg.total_steps, (params, opt_state), extra=self.data.state(self.cfg.total_steps))
        self._final = (params, opt_state)
        self.history = history
        return history

    @property
    def final_state(self):
        return self._final
