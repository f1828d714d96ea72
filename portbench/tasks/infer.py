"""The inference task: one client's closed loop of whole filter runs.

1. Set-up.  The configuration names its model: the program
   ``portbench/configs/<model>.py`` (``build(config) -> SSMDef``) and the
   plain reference ``portbench/reference/<model>.py``.  The filter is
   built from the configuration's ``filter`` settings, which the
   traffic's own ``filter`` settings override (any field of
   ``FilterConfig`` but the sizes).  The port's kernel library is loaded
   (built on a checkout's first run), and the cell's own filter runs its
   first ``warmup_generations``, so every shape, pool and kernel the
   window uses is allocated and loaded before it opens.
2. The window.  Whole ``ParticleFilter`` runs back to back, each on
   fresh observations drawn from the seed and the run's index; a run
   starts only while, judging by the longest run before it, it can end
   inside ``seconds``.  A CUDA event marks the start of every generation
   on the stream (no synchronize).  With ``trace`` the first run's
   middle ``profile_generations`` are profiled (:mod:`portbench.tracing`).
3. The check.  Every run's outputs, and the last run's trajectories in
   full, against the plain reference on the same inputs
   (:mod:`portbench.check`), once the window has closed, the peak memory
   has been read and the program's state is freed.

The traffic's parameters: ``warmup_generations``, ``profile_generations``,
``sample_particles`` (the particles whose trajectories every run
digests), and optionally ``filter``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from portbench import check, harness, tracing
from portbench.reference import filter as reference_filter
from portbench.reference.digest import Digest

#: particles a block of the last run's full read-back materializes at once
DIGEST_BLOCK = 16384
#: generations the profiler runs before the profiled block opens
PROFILE_LEAD = 4


class StopWarmup(Exception):
    """Raised by the step wrapper to end the warm-up run."""


class Recorder:
    """Wraps the model step: marks each generation's start on the device's
    stream (a CUDA event; the host clock on the CPU), runs the hooks of
    the traced block, names the step's span, and ends a warm-up."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.stamps: Optional[list] = None
        self.stop_at: Optional[int] = None
        self.hooks: dict = {}
        self.span: Optional[str] = None

    def stamp(self) -> Any:
        if self.dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, step: Callable) -> Callable:
        def wrapped(gen, state, t, y, params):
            if t == self.stop_at:
                raise StopWarmup
            hook = self.hooks.get(t)
            if hook is not None:
                hook()
            if self.stamps is not None:
                self.stamps.append(self.stamp())
            if self.span is None:
                return step(gen, state, t, y, params)
            with torch.profiler.record_function(self.span):
                return step(gen, state, t, y, params)

        return wrapped

    def gaps_ms(self, stamps: list) -> List[float]:
        """Milliseconds between consecutive stamps (after a synchronize)."""
        if self.dev.type != "cuda":
            return [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]


def filter_settings(cell: harness.Cell) -> dict:
    """The ``FilterConfig`` fields the configuration and traffic set."""
    settings = {**cell.config.get("filter", {}), **cell.traffic.get("filter", {})}
    if settings.get("resampler", "systematic") != "systematic" or settings.get("max_retries", 0):
        raise ValueError(f"{cell.name}: the reference follows systematic resampling without the "
                         f"alive filter's retries; settings {settings}")
    return settings


class Program:
    """The port's filter for a cell, and what a run reads from it."""

    def __init__(self, cell: harness.Cell, dev: torch.device):
        from repro_torch.core import store as store_lib
        from repro_torch.core.config import CopyMode
        from repro_torch.smc.filters import FilterConfig, ParticleFilter

        cfg = cell.config
        self.cell, self.dev, self.store_lib = cell, dev, store_lib
        self.n, self.t = cfg["n_particles"], cfg["n_steps"]
        model = cfg["model"]
        ssm = harness.load_module(cell.path("configs", f"{model}.py"), f"portbench_program_{model}").build(cfg)
        self.reference = harness.load_module(cell.path("reference", f"{model}.py"),
                                             f"portbench_reference_{model}")
        self.recorder = Recorder(dev)
        ssm = ssm._replace(step=self.recorder.wrap(ssm.step))
        settings = filter_settings(cell)
        if "mode" in settings:
            settings["mode"] = CopyMode[settings["mode"]]
        self.fcfg = FilterConfig(n_particles=self.n, n_steps=self.t, **settings)
        self.filter = ParticleFilter(ssm, self.fcfg, device=dev)
        self.elems = int(np.prod(ssm.record_shape))
        self.digest = Digest(self.t, self.elems, dev)

    def inputs(self, seed: int, k: int):
        """Run ``k``'s observations, filter generator and sampled particles."""
        data, draws, sample = np.random.SeedSequence([seed % (1 << 64), k]).spawn(3)
        obs = self.reference.simulate(self.cell.config, self.t, np.random.default_rng(data))
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(draws.generate_state(1, np.uint64)[0]) >> 1)
        s = min(self.cell.traffic["sample_particles"], self.n)
        ids = np.sort(np.random.default_rng(sample).choice(self.n, size=s, replace=False))
        return (torch.from_numpy(obs).to(self.dev), gen,
                torch.from_numpy(ids).to(self.dev))

    def warm_up(self, seed: int) -> None:
        """The cell's filter for ``warmup_generations``, then the
        sampling path once at its own sizes."""
        obs, gen, ids = self.inputs(seed, 0)
        self.recorder.stop_at = self.cell.traffic["warmup_generations"]
        try:
            self.filter.run(gen, None, obs)
        except StopWarmup:
            pass
        finally:
            self.recorder.stop_at = None
        cfg = self.filter.store_cfg
        self.digest.whole(torch.zeros((ids.shape[0], cfg.capacity, *cfg.item_shape), device=self.dev))
        from repro_torch.kernels.cow_gather import cow_gather

        cow_gather(torch.zeros((2, cfg.block_size, *cfg.item_shape), device=self.dev),
                   torch.tensor([0, -1], dtype=torch.int32, device=self.dev))
        harness.sync(self.dev)

    def run(self, seed: int, k: int, stamps: list):
        """One filter run: ``(check.RunOutputs, FilterResult)``."""
        obs, gen, ids = self.inputs(seed, k)
        self.recorder.stamps = stamps
        res = self.filter.run(gen, None, obs)
        stamps.append(self.recorder.stamp())
        self.recorder.stamps = None
        traj = self.store_lib.materialize_batch(self.filter.store_cfg, res.store, ids)
        out = check.RunOutputs(res.log_evidence.clone(), res.log_weights.clone(), res.oom.clone(),
                               ids, self.digest.whole(traj))
        return out, res

    def read_back(self, out: check.RunOutputs, res) -> None:
        """Every trajectory of the run ``res``, read back from its store in
        blocks: their digests, and their smoothing means and variances
        under the run's final weights."""
        w = torch.exp(res.log_weights.double() - torch.logsumexp(res.log_weights.double(), 0))
        moments = torch.zeros((2, self.t, self.elems), dtype=torch.float64, device=self.dev)
        parts = [[], []]
        for i in range(0, self.n, DIGEST_BLOCK):
            ids = torch.arange(i, min(i + DIGEST_BLOCK, self.n), device=self.dev)
            traj = self.store_lib.materialize_batch(self.filter.store_cfg, res.store, ids)
            traj = traj[:, : self.t].reshape(ids.shape[0], self.t, self.elems)
            for part, h in zip(parts, self.digest.whole(traj), strict=True):
                part.append(h)
            r = traj.double()
            moments += torch.einsum("i,kite->kte", w[ids], torch.stack([r, r * r]))
        out.full = (torch.cat(parts[0]), torch.cat(parts[1]))
        out.smooth, out.var = moments[0], moments[1] - moments[0] ** 2

    def reference_run(self, seed: int, k: int, dtype: torch.dtype = torch.float32, cdf: str = "rows"):
        """The plain reference on run ``k``'s inputs, computed in ``dtype``
        (bfloat16 is the control) with the CDF in order ``cdf``."""
        obs, gen, _ = self.inputs(seed, k)
        model = self.reference.Model(self.cell.config, self.dev, dtype)
        thr = None if self.fcfg.always_resample else self.fcfg.ess_threshold
        return reference_filter.run(model, self.elems, self.n, obs, gen, ess_threshold=thr, cdf=cdf)


class Tracer:
    """Profiles generations ``[first, first + gens)`` of one filter run."""

    def __init__(self, prog: Program):
        t_steps, want = prog.t, prog.cell.traffic["profile_generations"]
        self.gens = min(want, max(1, t_steps // 2))
        self.first = max(PROFILE_LEAD, t_steps // 2 - self.gens // 2)
        self.prog, self.prof, self.block_span = prog, None, None
        self.launches: dict = {}
        self.saved: list = []

    def arm(self) -> None:
        rec = self.prog.recorder
        rec.span = tracing.STEP
        rec.hooks = {self.first - PROFILE_LEAD: self._start, self.first: self._open,
                     self.first + self.gens: self._close}
        for mod_name, attr in tracing.SPANS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, _spanned(f"portbench.{attr}", fn))

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.prog.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def _open(self) -> None:
        from repro_torch.kernels import dispatch

        self.launches = dispatch.launch_counts()
        self.block_span = torch.profiler.record_function(tracing.BLOCK)
        self.block_span.__enter__()

    def _close(self) -> None:
        from repro_torch.kernels import dispatch

        self.block_span.__exit__(None, None, None)
        harness.sync(self.prog.dev)
        self.prof.stop()
        after = dispatch.launch_counts()
        self.launches = {k: after[k] - self.launches[k] for k in after if after[k] != self.launches[k]}
        self.prog.recorder.hooks = {}
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        self.saved = []

    def block(self) -> Optional[tracing.Block]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        return tracing.read_block(trace, self.gens, self.first)


def _spanned(name: str, fn: Callable) -> Callable:
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


def run(cell: harness.Cell, dev: torch.device, seed: int, seconds: float, trace: bool,
        t_start: float) -> harness.Outcome:
    phases = {"start": time.perf_counter() - t_start}
    prog = Program(cell, dev)
    phases["program"] = time.perf_counter() - t_start
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.library()
    phases["kernels"] = time.perf_counter() - t_start
    prog.warm_up(seed)
    setup_s = phases["warm_up"] = time.perf_counter() - t_start

    tracer = Tracer(prog) if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    outs, stamp_lists, walls, peak_blocks = [], [], [], []
    while not walls or time.perf_counter() - t0 + max(walls) <= seconds:
        res = None
        if tracer is not None and not walls:
            tracer.arm()
        t_run = time.perf_counter()
        stamps: list = []
        out, res = prog.run(seed, len(outs), stamps)
        harness.sync(dev)
        walls.append(time.perf_counter() - t_run)
        peak_blocks.append(int(res.store.peak_blocks))
        outs.append(out)
        stamp_lists.append(stamps)
    window_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    gaps = [g for stamps in stamp_lists for g in prog.recorder.gaps_ms(stamps)]
    values = {
        "particle_steps_per_s": prog.n * prog.t * len(outs) / window_s,
        "gen_p95_ms": float(np.percentile(gaps, 95)),
        "peak_mem_GiB": peak_bytes / 2**30,
        "setup_s": setup_s,
    }
    counters = {"peak_blocks": peak_blocks, "pool_blocks": res.store.pool.num_blocks}
    phases["window"] = window_s
    t_check = time.perf_counter()
    prog.read_back(outs[-1], res)
    res = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phases["read_back"] = time.perf_counter() - t_check
    refs = [prog.reference_run(seed, k) for k in range(len(outs))]
    harness.sync(dev)
    phases["reference"] = time.perf_counter() - t_check
    nums = check.numbers(outs, refs)
    _, rows = check.judge(nums, cell.config["limits"])
    block = tracer.block() if tracer is not None else None
    if block is not None:
        print(f"traced block: generations {block.first_generation}.."
              f"{block.first_generation + block.generations - 1}, "
              f"{len(block.kernels)} kernels, {block.untraced_launches} without a traced launch; "
              f"port kernel launches (counters): {tracer.launches}; device s by span: "
              f"{ {k: round(v, 4) for k, v in tracing.by_span(block).items()} }", file=sys.stderr)
    phases["done"] = time.perf_counter() - t_start
    print("phases (s): " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
          + f"; window runs {[round(w, 2) for w in walls]}", file=sys.stderr)
    return harness.Outcome(
        attempted=len(outs), failed=sum(int(bool(o.oom)) for o in outs), values=values,
        peak_bytes=peak_bytes, checks=rows, diagnostics={k: nums[k] for k in check.DIAGNOSTIC},
        counters=counters, block=block)

