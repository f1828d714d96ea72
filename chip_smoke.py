#!/usr/bin/env python3
"""Drive the PyTorch port of the lazy-copy platform on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
   process per source, in parallel), and print ptxas' registers and
   spills for every kernel instantiation.
2. The particle filter's path, with every kernel's launch counter set to
   0 just before and read just after: the LGSSM particle filter of
   ``examples/quickstart.py`` (A=0.9, Q=0.5, R=0.3, record ``(1,)``,
   block_size 4, auto pool, N = 65,536, T = 1,024) in EAGER, LAZY and
   LAZY_SR with the systematic resampler from one generator seed —
   ``log_evidence`` must be bit-identical across modes, ``oom`` False,
   and the lazy peak below the dense block count; LAZY_SR's
   ``materialize_batch`` of all N must equal EAGER's dense trajectories
   before and after ``compact``; then one LAZY run with the stratified
   resampler (``refcount_update`` through ``store.clone``).  Each of the
   four COW kernels must have launched.
3. Each COW kernel against its plain PyTorch version on the card, at the
   filter's shapes and on its state: exact equality (NULL entries, masked
   rows and duplicate ids included); then each one's time, its plain
   version's time, the time of one PyTorch call computing the same
   function where there is one, and the least time the card could take
   (bytes moved over the memory rate).  Times are device time per call
   between CUDA events, the calls queued behind a spin kernel.
   ``refcount_update`` gets the tables' row length and prints the premise
   of its design: the mean run of one block down the particle axis and
   the number of distinct blocks; ``clone_chain`` prints the same premise
   (the mean runs of its new and old tables).  ``cow_write`` must leave
   the dump row zero, also one that held data before the call (its CUDA
   route zeroes it in the same launch).
4. A small filter run on the card against the same run on the CPU path,
   fed the same draws: equal tables, log-evidence to rtol 1e-5.
5. One more LAZY_SR run under ``torch.profiler`` (CUDA activity only),
   run last, after phases 6-9.  A profile's device numbers are null unless
   its trace holds a record of every launch of a kernel whose wrapper
   counts them (``cow_write`` here, ``paged_attention`` in phase 6).
6. The serving path, with the counters set to 0 just before and read
   just after: ``ServeEngine`` on starcoder2-3b at its published widths
   (30 layers, d_model 3072, 24 heads over 2 KV heads, d_ff 12288, vocab
   49152; bf16 activations, f32 params; random weights from seed 0).
   Prefill 4 prompts of 500 tokens into a 16-slot engine (pages of 16
   tokens, ``num_blocks = pool_blocks_cap``), fork to 16 rows, decode 128
   sampled tokens with a re-fork at token 64, ``compact_cache`` and one
   more token — once with whole-page COW and once with delta COW.
   Checks: ``oom`` False; the copies' first logits bit-equal to their
   siblings'; live pages below the dense count; the step after
   ``compact_cache`` equal to the same step on an uncompacted copy; the
   two runs bit-identical in every logit and token; ``paged_attention``,
   ``paged_attention_delta`` and ``cow_gather`` launched.  Then eight
   decode steps under ``torch.profiler`` (``serve_profile``).  Each call
   of the paged kernel launches the split kernel, whose name holds
   ``paged_attention_kernel``, and then its merge,
   ``paged_attention_combine``, which does not: the trace is complete
   when it holds exactly one ``paged_attention_kernel`` record per counted
   launch.
7. Both paged-attention kernels against their plain version on the final
   caches (layers 0 and 29, bf16, atol 1e-2): a repeat call bit-equal to
   the first (the splits merge in a fixed order), and two planted faults,
   each the plain version on altered inputs, that must read above the
   limit: the first page of the second split dropped from every row, and
   every length one slot short.  Then their times, the plain version's,
   and the bound (the live K/V slots, tables, q and out over the memory
   rate); ``pool_compact`` on the 491,520-byte pages.
8. The smoke config (3 layers, d_model 96, f32) on the card against the
   CPU path, through ``repro_torch.serving.crosscheck``: equal tables,
   refcounts and lengths, logits within 1e-5 of the step's largest logit,
   delta on/off bit-identical; both kernels within atol 1e-5 of the plain
   version on its f32 pools.
9. The serve entry point as a user runs it, ``python -m
   repro_torch.launch.serve --full`` (starcoder2-3b at full width, 4
   requests x 32 greedy tokens), with the counters set to 0 just before:
   ``paged_attention`` launched, 4 continuations of 33 tokens returned.
10. The store's sub-block delta COW at the filter's scale, with the
    counters set to 0 just before and read just after: the LGSSM
    (N = 65,536, T = 1,024) driven through the store API (LAZY_SR,
    block_size 8, record ``(1,)``, auto pool; each generation
    ``store.clone_chain`` on the log-weights, then ``store.append``),
    once with ``delta_cow`` off and once on, from one generator seed.
    Checks, mid-block (T/2 + 4 items) and at the end: ``materialize_batch``
    of all N (valid prefix) and ``read_at`` bit-equal between the runs;
    ``oom`` False; the pool's invariants; delta blocks made; ``cow_write``
    and ``cow_write_delta`` launched.  Prints the bytes per append each
    write kernel must move, and ``{"delta_profile": ...}``: 8 generations
    of the delta run after the mid-block check traced, launches per
    generation counted and traced, one ``cow_write_delta_kernel`` record
    per counted launch.  Then ``cow_write_delta`` against its plain
    version on a mid-block append's own routing: exact; a dump row dirty
    on entry zero after; one kernel record a call (traced).
11. ``resample``, ``flash_attention`` and ``ssd_scan`` reached through
    the registry at the widths of the models the repository configures
    (flash and the SSD scan have their model path in phase 16),
    with the counters set to 0 just before and read just after:
    ``resample`` (N = 65,536, phase 2's final LAZY weights, and the
    planted CDFs of ``kernels/resample/ref.py``; exact, one launch and one
    traced kernel record a call; the launch floor, a 4-byte ``zero_()``
    between the same events, printed beside it and in every row of the
    ``kernels`` line whose bound lies below it),
    ``flash_attention`` (starcoder2-3b: 24 heads over 2 KV heads, d 128,
    bf16, B = 4 x S = 512 and B = 1 x S = 4,096; gemma3-12b: 16 heads
    over 8, d 256, window 1,024, S = 4,096; bf16 atol 2e-2, and each
    element within 1.25 times its rounding bound of the plain version in
    f32, a bound that two planted faults must exceed) and
    ``ssd_scan`` (mamba2-130m: 24 heads, P 64, N 128, chunk 64, f32, B = 4
    x S = 2,048; rtol/atol 2e-4; a repeat call bit-equal; its two
    launches' times, traced), each against its plain version on the
    card, with its times and bound; flash's library time is SDPA with
    ``enable_gqa`` (causal, or a boolean causal-and-window mask).
    ``cow_write_delta``'s, ``ssd_scan``'s and ``resample``'s lines print
    their time before their redesign beside this run's.
12. SMC decoding through the continuous-batching scheduler, with the
    counters set to 0 just before the main run and read just after:
    starcoder2-3b at its published widths (random weights from seed 0, the
    embedding table scaled by 1/sqrt(d_model), see ``smc_decode_phase``),
    two requests of 16 particles in one 32-row engine (pages of 16, the
    automatic pool, growth on), prompts of 500 tokens, 64 steps each,
    target temperature 0.7, proposal 1.0, ESS threshold 0.5, LAZY_SR token
    store.  Checks: ``oom`` False; each request resampled; peak KV pages
    below the dense count; ``paged_attention``, ``clone_chain``,
    ``cow_write`` and ``cow_gather`` launched.  Then, each bit-exact
    (tokens, log-weights, log-evidence, ESS, resampling steps) with the
    main run: each request alone on an engine of the same 32 rows (cuBLAS
    may pick another GEMM for another row count); a forced preemption at
    tick 20 and its replay; ``STEP_FAILURE`` then ``OOM`` on the first
    tick that forks (two rollbacks, invariants clean); a checkpoint at
    tick 32 restored on a fresh engine; the run with ``kv_delta_cow``
    (``paged_attention_delta`` launched, counted from 0).  ``cow_write``
    and ``clone_chain`` equal their plain versions on the inputs of the
    token store's last calls (int32, items ``()``).  ``python -m
    repro_torch.launch.serve --smc`` runs.  Prints ``{"smc_decode": ...}``:
    the median wall per tick, launches per tick, peak against dense
    pages, growth, and the rollback snapshot's bytes and device time.
13. An SMC fleet through the replica router, on phase 12's weights and
    cache config: ``traces.staggered(4, 8)`` of phase 12's requests (16
    particles, prompts of 500 tokens, 64 steps), lowered on the card by
    ``traces.to_decode_requests``, through fleet A (``make_replicas``, 2
    replicas on the one card, ``least_loaded``, driven through
    ``Router.stream()`` with the counters set to 0 just before and read
    just after) and fleet B (1 replica), every scheduler with its own
    ``SchedulerEventLog``.  Checks: every request's tokens, log-weights,
    log-evidence, ESS and resampling steps bit-equal between A and B (both
    engines of 32 rows); A places on both replicas, B queues (its
    ``queue_p99`` in rounds above 0), a request resamples; the tokens
    rebuilt from A's stream of ``TokenEvent`` records equal its results; each
    scheduler's log replays through ``sim.simulate`` with
    ``CostModel.from_event_log`` decision-exact, with equal peak pages and
    ``SchedulerStats``, its simulated time within [0.75, 1.25] of the
    recorded wall; A's router log equals ``simulate_router``'s over the
    union of its replicas' recorded traces; replica 1's first
    paged-attention call of its tick 48 (layer 0, both of its requests
    live) within 1e-2 of the plain version, a repeat call bit-equal;
    ``paged_attention``, ``clone_chain``, ``cow_write`` and ``cow_gather``
    launched.  Prints ``{"fleet": ...}``: placements, rounds, latency in
    rounds, utilization, each replica's peak pages and simulated/recorded
    time, resamples, the median tick wall beside
    ``CostModel.from_roofline``'s step time; the launches go into the
    ``kernels`` rows as ``fleet_launches``.
14. The paper's five programs (``repro_torch.smc.programs``) at the
    paper's N and T, each in EAGER, LAZY and LAZY_SR from one generator
    seed on data from its own ``gen_data``, with the counters set to 0
    before each program and read after it: RBPF (N = 2,048, T = 500),
    PCFG (N = 16,384, T = 1,000 of the paper's 3,262, the auxiliary filter with its lookahead
    and its stack in a second store), VBD (N = 4,096, T = 182, particle
    Gibbs, 3 iterations), MOT (N = 4,096, T = 100), CRBD (N = 5,000,
    T = 173, the alive filter with ``max_retries=6``).  Checks:
    ``log_evidence`` (VBD: each iteration's) bit-identical across modes;
    LAZY_SR's ``materialize_batch`` of all N equal to EAGER's dense
    trajectories (VBD: the retained reference equal across modes); ``oom``
    False; LAZY_SR's peak below the dense count (all but PCFG, whose stack
    store must stay within N x ``max_blocks``); ``cow_write`` launched for
    all five, ``clone_chain`` for all but VBD, ``refcount_update`` for PCFG
    and VBD, ``cow_gather`` for VBD.  Each program also runs at N = 64,
    T = 16 on the CPU path and on the card on the same draws (a
    ``Replay`` of the CPU run's): ancestors, tables, ``resampled``, stack
    pointers, exists masks and hidden counts equal, ``log_evidence`` to
    rtol 1e-5.  ``cow_write`` on PCFG's last generation's 12 masked stack
    writes, ``refcount_update`` on its last stack clone and ``cow_gather``
    on VBD's last ``materialize`` (kept from the LAZY runs) equal their
    plain versions; a masked ``write_at`` at depth 63 on shared LAZY
    stacks equals the CPU path, the dump row zero.  Prints
    ``{"programs": ...}``: per program N and T, the median wall per
    generation in LAZY_SR (the card drained at each generation's start),
    launches per generation, peaks against dense, ``log_evidence``; the
    launches go into the ``kernels`` rows as ``programs_launches``.

15. The moe and audio families at full width, each model drawn on the
    card leaf by leaf with every layer matrix cast to bf16 as it is drawn
    (``serving.engine.draw_cast_params``; the router stays float32), the
    peak device memory printed.  deepseek-moe-16b as the repo's
    ``ModelConfig`` reads it (28 layers, layer 0 dense with d_ff 11,264;
    d_model 2048; 16 heads over 16 KV heads of 128; 64 routed experts
    top-6 plus 2 shared, expert d_ff 1408; vocab 102,400, untied;
    capacity factor 1.25), its unembedding scaled by 8 (as drawn the
    proposal is near flat, see ``MOE_UNEMBED_SCALE``): 4 prompts of 500
    tokens served on 16 rows (16 sampled tokens), whole-page and delta
    COW, bit-identical; then phase 12's two 16-particle requests on 32
    rows with 32 steps through the scheduler (counters from 0; each
    request resampled; ``paged_attention``, ``clone_chain``,
    ``cow_write``, ``cow_gather`` launched), the delta-COW run and a
    checkpoint at tick 16 restored on a fresh engine, both bit-exact; each
    request alone and a preemption at tick 10 run and reported, not
    required (expert capacity couples the rows of a step); the (token,
    expert) pairs dropped at tick 24 from the routing's keep mask; tick
    24's ``paged_attention`` (whole-page, from the restored run) and
    ``paged_attention_delta`` calls (G = 1, head dim 128) and the token
    store's last ``cow_write``, ``clone_chain`` and final ``cow_gather``
    against their plain versions; ``python -m repro_torch.launch.serve
    --arch deepseek_moe_16b --full``.  musicgen-large (48 layers, d_model
    2048, 32 heads over 32 of 64, GELU MLP, vocab 2,048): served the same
    way, bit-identical, its last step's paged attention (head dim 64)
    against the plain version, and its serve CLI.  The smoke configs of
    both on the card against the CPU path (``crosscheck``: routing equal
    wherever the k-th and (k+1)-th gates lie more than 1e-4 apart).
    Prints ``{"families": ...}``; the launches and the new shapes' times
    go into the ``kernels`` rows as ``family_launches`` and
    ``family_shapes``.
16. The dense-cache families at full width, on ``LanguageModel``'s
    ``prefill`` and ``decode_step``, one model at a time, each drawn on
    the card leaf by leaf with its matrices cast to bf16 as drawn (the
    norm scales and the SSM's ``a_log``, ``dt_bias``, ``d_skip`` stay
    float32), random weights from the seed, the peak memory printed:
    mamba2-130m (24 layers, batch 4, prompt 1,984, 64 greedy steps),
    zamba2-7b (81 SSM layers, the shared block 13 times; 4, 960, 64),
    gemma3-12b (48 layers, window 1,024; 2, 2,016, 32: the rings wrap)
    and llama-3.2-vision-90b cut to 20 layers (4 units; 2, 480, 32, with
    1,024 image tokens of normal features from the seed).  With the
    counters set to 0 before each model and read after its prefill and
    after its teacher-forced forward (prompt plus steps): ``flash_attention``
    and ``ssd_scan`` launched exactly as predicted (a flash launch per
    self-attention layer or shared-block invocation, a scan per SSM layer,
    each pass); finite logits and caches, ``position`` = prompt + steps;
    each decode step against the forward at its position (the worst gap
    in units of the step's largest |logit|, and the greedy agreement:
    recorded in bf16, no limit); the prefill's first and last ``flash``
    and ``ssd_scan`` calls against their plain versions (flash bf16: atol
    2e-2 and the rounding bound; SSD: rtol/atol 2e-4), with their times,
    the plain versions', SDPA's and the bound.  Then the four smoke
    configs on the card against the CPU path
    (``crosscheck.dense_cache_card_against_cpu``, f32: logits within 1e-5
    of the step's largest, the SSM families within 2e-5), and for mamba2
    and zamba2 each of the crosscheck's planted scan faults (B and C
    rounded to bf16; the later half of the outputs 1e-4 off) reading
    above that limit on the card.
    Then the card where it used to raise: the mamba2 and zamba2 smoke
    configs at prompts of 1, 20 and 40 tokens (the chunk ``min(64, S)`` no
    multiple of 16: the scan runs over a ``dt = 0`` tail), within the same
    limit of the CPU, one scan launch an SSM layer; bf16 flash at head dims
    16 and 32 (the CUDA-core kernel, ``[2, 512, 8 over 2]``) against its
    plain version as above, with its times.
    Prints ``{"dense_cache": ...}``; the ``flash_attention`` and
    ``ssd_scan`` rows take this phase's launches as ``launches`` (the
    registry's as ``registry_launches``) and its shapes' times as
    ``dense_cache_shapes``.
17. The sharded store (``repro_torch.distributed``), run after phase 13
    on phase 12's weights: the store program (N = 4,096, block 4, 8
    blocks a particle, items ``(1,)``: appends, a clone on uniform random
    ancestors, a within-shard pair clone, ``write_at``, lockstep ``grow``
    and ``compact``) on 1, 2 and 4 in-process shards in every mode, each
    stacked leaf, the trajectories and the per-shard blocks equal on the
    card and on the CPU; the LGSSM at N = 65,536, T = 256 (``SHARDED_T``)
    on one device and over 1, 2 and 4 shards, the 4-shard runs in every
    mode, with the counters set to 0 just before the 4-shard LAZY_SR run
    and read just after (``cow_write``, ``refcount_update`` and
    ``cow_gather`` launched once a call of the store, counted by call:
    an append a shard a generation, a clone and an export gather a shard
    a resampling generation).  Checks: ``oom`` False; 4 shards'
    ``log_evidence`` bit-identical across modes, LAZY_SR's trajectories
    equal EAGER's, its blocks below 0.6 x EAGER's; 1 shard bit-exact with
    the single-device run (every store leaf, the log-weights); an NCCL
    process group of one rank (a ``file://`` rendezvous in a temporary
    directory) bit-equal to the in-process shard; that run's last
    ``cow_write``, ``refcount_update`` and export ``cow_gather``, and a
    ``trajectories`` gather, against their plain versions (exact), with
    their times; the token trace's import-skew case (one lockstep growth
    before the clone, no ``oom``, the histories exact); a 2-shard
    ``SMCDecoder`` on phase 12's request shape (16 particles, a prompt of
    500 tokens, 16 steps, ESS threshold 1.0 so most steps resample)
    bit-equal to the unsharded one (tokens, log-weights, log-evidence,
    resampling steps).  Prints ``{"sharded": ...}`` (walls a generation,
    per-shard used and peak blocks, the exchange's bytes a generation);
    the three rows take the path's launches as ``sharded_launches`` and
    its calls' times as ``sharded_shapes``.

18. Training (run after phase 16), with the counters set to 0 just
    before each path and read just after.  (a) Each backward kernel
    against its plain version (autograd of the plain forward) on the
    card: ``flash_attention_bwd`` in bf16 on the tensor cores (wgmma) at
    starcoder2-3b's training shape (2 x 4,096, 24 heads over 2, d 128),
    at gemma3-12b's local layer (1 x 4,096, 16 over 8, d 256, window
    1,024) and at zamba2-7b's prefill shape (4 x 960, 32 over 32, d 112,
    whose last 16 columns TMA fills with zeros), and in f32 on the CUDA
    cores at d 16 and 32 (2 x 512, 8 over 2); ``ssd_scan_bwd``
    (chunk-parallel, mma.sync TF32) in f32 at mamba2-130m's heads (2 x
    4,096, 24 heads, P 64, N 128, chunk 64, with the final state's
    gradient).  Each case prints its route.  Each gradient within
    ``BWD_TOL`` (f32 1e-4, bf16 2e-2) of its plain version's largest
    magnitude, two planted faults per case (flash: the last query tile's
    dO dropped, the first key tile's K zeroed; SSD: B and C rounded to
    bf16, the last chunk's dy dropped) reading above that limit, two
    calls bit-equal; for flash, the gradients of autograd through
    ``flash_attention`` (whose ``Function`` keeps the forward's row
    log-sum-exp) bit-equal to a direct call's (given it by
    ``forward_lse``).  (b) Their times (the tensor-core flash given the
    forward's log-sum-exp, as training calls it), the plain versions',
    the bound at the kernel's route (bytes over the memory rate or 2.5
    times the forward's flops over the peak of the route's type: bf16
    or f32 for flash, TF32 for SSD; SSD's also at the f32 CUDA-core
    rate, ``bound_f32_ms``, as the first version's row had it) and, for flash, SDPA's
    backward and both forward-plus-backward pairs.  (c) mamba2-130m uncut
    through ``python -m repro_torch.launch.train --full``'s ``main``
    (sequence 4,096, global batch 8 in 4 microbatches of 2, f32 master
    weights, 6 steps, a checkpoint at step 3, the corpus drawn from 4,096
    of its 50,280 tokens) under ``torch.use_deterministic_algorithms``,
    then the same run crashed at step 4 and relaunched: the resumed losses
    and the final params and moments bit-equal to the uninterrupted run's;
    ``ssd_scan_bwd`` once and ``ssd_scan`` twice a layer a microbatch
    (remat).  (d) starcoder2-3b at its published widths through
    ``make_train_step`` (the bf16 compute copy, bf16 gradients, per-layer
    remat, one microbatch of 2 x 4,096, 3 steps): finite losses and grad
    norms, ``flash_attention_bwd`` once and ``flash_attention`` twice a
    layer a step, the peak memory.  (e) The smoke configs of the seven
    families, one ``make_train_step`` each on the card and on the CPU
    from the same params and batch, within ``SMOKE_TRAIN_TOL``.  Prints
    ``{"train": ...}`` (step walls, tokens a second, peak memory,
    launches by kernel) and adds the ``flash_attention_bwd`` and
    ``ssd_scan_bwd`` rows.

Phase 14 runs PCFG at T = 1,000 (``PROGRAM_T``; the paper's 3,262 is
its ``PAPER_T``), so the script keeps within its time budget.

Output: a line per run, the ``{"profile": ...}``, ``{"serve_profile": ...}``,
``{"smc_decode": ...}``, ``{"fleet": ...}``, ``{"sharded": ...}``, ``{"programs": ...}``, ``{"families": ...}``, ``{"dense_cache": ...}``, ``{"train": ...}`` and ``{"kernels": [...]}`` JSON lines, the card's name and power limit
from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

# Phase 18 runs under torch.use_deterministic_algorithms(True), whose cuBLAS
# calls need a fixed workspace, set before CUDA is first initialised.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
A, Q, R = 0.9, 0.5, 0.3
SEED = 0
N_PARTICLES = 65_536
N_STEPS = 1_024

# Memory rate of each part (NVIDIA data sheets), bytes/s; the name from
# torch.cuda.get_device_name picks the row.
MEMORY_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# The kernels the particle filter's path runs (the serving path's are
# checked in serve_phases).
FILTER_OPS = ("cow_write", "refcount_update", "cow_gather", "clone_chain")
# Dense float32 peak outside the tensor cores, and dense bf16 and TF32
# tensor-core peaks, H100 SXM.
F32_RATE = 67e12
BF16_RATE = 989e12
TF32_RATE = 495e12
# Phase 10: the delta store's block size, and the mid-block generation at
# which the two runs are also compared (delta blocks live there).
DELTA_BLOCK = 8
DELTA_MID = N_STEPS // 2 + 4
# Phase 11: flash attention at starcoder2-3b's widths (24 heads over 2 KV
# heads, d 128) at two prefill shapes and at gemma3-12b's local layers (16
# over 8, d 256, window 1,024): (name, B, S, H, KVH, d, window), bf16.
FLASH_CASES = (
    ("starcoder2-3b B=4 S=512", 4, 512, 24, 2, 128, 0),
    ("starcoder2-3b B=1 S=4096", 1, 4096, 24, 2, 128, 0),
    ("gemma3-12b local B=1 S=4096", 1, 4096, 16, 8, 256, 1024),
)
# How far past its first-order rounding bound (flash_rounding_bound) a
# bf16 flash output may lie: second-order terms and f32 sums in another
# order add well under 1%.
FLASH_BOUND_LIMIT = 1.25
# The SSD scan at mamba2-130m's widths (d_inner 1536 = 24 heads of 64,
# state 128, chunk 64), f32: (B, S, H, P, N, chunk).
SSD_SHAPE = (4, 2048, 24, 64, 128, 64)
# The redesigned kernels' times before their redesign, printed beside
# this run's (ms a call at these shapes; PERF.md §6, NVIDIA H100 80GB
# HBM3 at 700 W).
EARLIER_MS = {"cow_write_delta": 0.01127, "ssd_scan": 3.070, "resample": 0.00514}
# csrc/resample.cu: outputs per CTA, the floats of a tile's source range
# it stages in shared memory (wider ranges search `cum` itself), and the
# entries either side of a tile's own indices in its first guess.
RESAMPLE_TILE = 512
RESAMPLE_STAGE = 4096
RESAMPLE_SLACK = 244
# Phase 10: delta-store generations traced after the mid-block check.
TRACE_GENS = 8


def comb_tiles(cum, u) -> dict:
    """Per tile of RESAMPLE_TILE outputs: the span of its ancestors, and
    whether resample.cu's first guess holds them (they lie within
    RESAMPLE_SLACK of the tile's own indices; ``slack_for_all``: the
    slack that every tile's would need)."""
    from repro_torch.kernels.clone_chain.ref import comb_positions

    n = cum.shape[0]
    raw = torch.searchsorted(cum, comb_positions(u.reshape(()), n), side="left")  # before the clip
    first = torch.arange(0, n, RESAMPLE_TILE, device=cum.device)
    last = (first + RESAMPLE_TILE - 1).clamp(max=n - 1)
    spans = raw[last].clamp(max=n - 1) - raw[first] + 1
    reach = torch.maximum(first - raw[first], raw[last] - last - 1).clamp(min=0)
    held = reach <= RESAMPLE_SLACK
    return {"tiles": int(first.numel()), "span_mean": spans.float().mean().item(),
            "span_max": int(spans.max()), "wider_than_stage": int((spans > RESAMPLE_STAGE).sum()),
            "guess_holds": int(held.sum()), "slack_for_all": int(reach.max())}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def lgssm(rnd, SSMDef):
    def init(gen, n, params):
        return rnd.normal(gen, (n,))

    def step(gen, x, t, y, params):
        x = A * x + math.sqrt(Q) * rnd.normal(gen, x.shape)
        logw = -0.5 * ((y - x) ** 2 / R + math.log(2 * math.pi * R))
        return x, logw, x[:, None]

    return SSMDef(init=init, step=step, record_shape=(1,))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Cycles of the spin kernel that holds the card while device_ms enqueues
# its calls (about 0.1 s at the H100's clock).
SPIN_CYCLES = 200_000_000


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call between CUDA events, with the calls queued
    behind a spin kernel so that the host's launch gaps do not show (a call
    that waits on the host still counts its wait).  Not torch.profiler:
    once a process has traced ~1e5 kernels, CUPTI loses some of the kernel
    records of later sessions, and in some processes delivers none."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require_one_kernel_a_call(per_call: dict, kernel: str, what: str) -> None:
    """Where CUPTI delivered records (``traced_per_call``), every traced
    kernel is ``kernel``, at most one record a call.  CUPTI may drop a
    record but adds none, so a share below one a call is its loss, and
    the trace's completeness is printed."""
    if per_call:
        require(all(kernel in name and v["records"] <= 1.0 for name, v in per_call.items()),
                f"{what}: one launch a call, its kernel's ({per_call})")
        records = [v["records"] for v in per_call.values()]
        print(f"{what}: traced records per call {records} "
              f"({'complete' if records == [1.0] else 'CUPTI dropped some'})", flush=True)


def kernel_events(prof) -> dict:
    """Each CUDA kernel's name in a finished profile: (device µs, count)."""
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us, count = out.get(ev.key, (0.0, 0))
            out[ev.key] = (us + ev.self_device_time_total, count + ev.count)
    return out


def profile_summary(prof, wall_ms: float, per: int, unit: str, kernel: str, launched: int) -> dict:
    """Device busy time, idle share, launches and the top kernels per
    ``unit``.  The trace is complete when it holds a record of each of the
    ``launched`` launches of ``kernel`` (from its wrapper's counter); the
    device numbers are None when it is not, as CUPTI may drop records."""
    events = kernel_events(prof)
    busy_ms = sum(us for us, _ in events.values()) / 1e3
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:8]
    recorded = sum(c for k, (_, c) in events.items() if kernel in k)
    complete = recorded == launched > 0
    return {
        "records_complete": complete,
        f"{kernel}_records": recorded, f"{kernel}_launches": launched,
        f"traced_wall_ms_per_{unit}": wall_ms / per,
        f"device_busy_ms_per_{unit}": busy_ms / per if complete else None,
        "device_idle_share": 1 - busy_ms / wall_ms if complete else None,
        f"device_launches_per_{unit}": sum(c for _, c in events.values()) / per if complete else None,
        f"top_kernels_ms_per_{unit}": {k[:72]: us / 1e3 / per for k, (us, _) in top} if complete else None,
    }


def ptxas_report(log: str) -> list:
    """(function, registers, spill store bytes, spill load bytes) of each
    function in a ``-Xptxas=-v`` build log; the paged-attention
    instantiations by their template arguments."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
            if m := re.search(r"paged_attention_kernelI(13__nv_bfloat16|f)Lb([01])ELi(\d+)E", name):
                dtype = "bf16" if m.group(1) != "f" else "f32"
                name = f"paged_attention_kernel<{dtype}, delta={m.group(2)}, d={m.group(3)}>"
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return rows


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


# starcoder2-3b at its published widths (the repo's ModelConfig reading:
# 30 layers, d_model 3072, 24 heads over 2 KV heads, d_ff 12288, vocab
# 49152, bf16 activations, f32 params), random weights from seed 0.
SERVE_PROMPTS = 4
SERVE_PROMPT_LEN = 500  # not a multiple of the page: every tail page is part full
SERVE_SLOTS = 16
SERVE_BLOCK = 16
SERVE_MAX_LEN = 656
SERVE_TOKENS = 128
SERVE_REFORK_AT = 64
SERVE_PROFILE_TOKENS = 8


def gumbel_sample(logits, gen):
    """One token per row from softmax(logits), by Gumbel-max on the
    generator's uniforms: the same logits and generator state give the
    same tokens."""
    from repro_torch import random as rnd

    return torch.argmax(logits + rnd.gumbel(gen, logits.shape), dim=-1)


def clone_cache(cache):
    pool = type(cache.pool)(*(t.clone() for t in cache.pool))
    return type(cache)(pool, cache.tables.clone(), cache.lengths.clone())


def paged_bytes(cache, delta: bool, n_heads: int) -> int:
    """Bytes paged attention must move on ``cache``: each distinct K/V slot
    the rows read (a shared page counted once), each row's table entries up
    to its length, lengths, q and out, and under delta the parent and
    dirty entries of the pages read."""
    bs, kvh, hd = cache.pool.data.shape[3:]
    lengths = cache.lengths.long()
    pos = torch.arange(cache.tables.shape[1] * bs, device=lengths.device)
    live = pos[None, :] < lengths[:, None]  # [B, nb * bs]
    page = cache.tables.long().repeat_interleave(bs, dim=1)
    slot = (pos % bs)[None, :].expand_as(page)
    src = page
    if delta:
        par = cache.pool.parent.long()[page.clamp(min=0)]
        clean = ~cache.pool.dirty[page.clamp(min=0), slot]
        src = torch.where(clean & (par >= 0), par, page)
    ok = live & (page >= 0)
    n_slots = int(torch.unique(src[ok] * bs + slot[ok]).numel())
    elem = cache.pool.data.element_size()
    b, h = cache.tables.shape[0], n_heads
    pages_read = int(((lengths + bs - 1) // bs).sum())
    meta = pages_read * 4 + b * 4
    if delta:
        meta += int(torch.unique(page[ok]).numel()) * (4 + bs)
    return n_slots * kvh * hd * 2 * elem + meta + 2 * b * h * hd * elem


def serve_phases(dev, rate):
    """Phases 6-9: the COW-paged serving engine on starcoder2-3b at full
    width (whole-page and delta COW, bit-identical), each paged-attention
    kernel against its plain version on the final cache, the smoke config
    on the card against the CPU path, and the serve entry point at full
    width.  Returns the kernels' rows."""
    from repro_torch.configs.starcoder2_3b import CONFIG, SMOKE
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_gather import cow_gather_ref, pool_compact
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
    from repro_torch.kernels.paged_attention.ops import split_plan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.crosscheck import LOGIT_TOL, card_against_cpu
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CONFIG
    lm = LanguageModel(cfg)
    t = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    base = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS,
        max_blocks_per_seq=-(-SERVE_MAX_LEN // SERVE_BLOCK), dtype=cfg.dtype,
    )
    # Independent prompts: the auto size (the forked-population bound,
    # base.pool_blocks) would run out of pages; take the cap.
    base = kvc.KVCacheConfig(**{**vars(base), "num_blocks": base.pool_blocks_cap})
    eng = ServeEngine(lm, params, base, device=dev)
    weights = eng.params  # matrices cast to bf16 once; shared by both runs
    del params
    torch.cuda.synchronize()
    print(f"serve: starcoder2-3b weights drawn and cast in {time.perf_counter() - t:.1f} s; "
          f"pool {base.pool_blocks} pages of {eng.cache.pool.data[0].numel() * 2} bytes "
          f"(auto size would be {kvc.KVCacheConfig(**{**vars(base), 'num_blocks': 0}).pool_blocks})",
          flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 5), device=dev)
    groups = SERVE_SLOTS // SERVE_PROMPTS

    def serve(delta_cow: bool, engine=None):
        ccfg = kvc.KVCacheConfig(**{**vars(base), "delta_cow": delta_cow})
        engine = engine or ServeEngine(lm, weights, ccfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = engine.prefill(prompts, torch.arange(SERVE_PROMPTS, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        out = {"logits": [logits], "tokens": [], "prefill_s": prefill_s}
        anc = torch.arange(SERVE_SLOTS, device=dev) // groups
        tok = gumbel_sample(logits, gen)[anc][:, None]
        engine.fork(anc)
        used = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for step in range(SERVE_TOKENS):
            if step == SERVE_REFORK_AT:
                anc = torch.randint(0, SERVE_SLOTS, (SERVE_SLOTS,), generator=gen, device=dev)
                engine.fork(anc)
                tok = tok[anc]
            logits = engine.decode(tok)
            tok = gumbel_sample(logits, gen)[:, None]
            out["logits"].append(logits)
            out["tokens"].append(tok)
            used.append(kvc.used_blocks(engine.cache))
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t
        first = out["logits"][1].view(SERVE_PROMPTS, groups, -1)
        require(torch.equal(first, first[:, :1].expand_as(first)),
                "after the fork, the copies' first-step logits are bit-equal to their siblings'")
        used = torch.stack(used).cpu()
        steps = torch.arange(1, SERVE_TOKENS + 1)
        dense = SERVE_SLOTS * ((SERVE_PROMPT_LEN + steps + SERVE_BLOCK - 1) // SERVE_BLOCK)
        require(bool((used < dense).all()), "live pages stay below the dense count")
        # compact_cache, against the same step on an uncompacted copy
        uncompacted = clone_cache(engine.cache)
        engine.compact_cache()
        after = engine.decode(tok)
        compacted_cache = engine.cache
        engine.cache = uncompacted
        require(torch.equal(after, engine.decode(tok)),
                "the step after compact_cache gives the uncompacted copy's logits")
        engine.cache = compacted_cache
        out["logits"].append(after)
        require(not engine.oom, f"delta_cow={delta_cow}: oom is False")
        for lg in out["logits"]:
            require(bool(torch.isfinite(lg).all()) and lg.shape[-1] == cfg.padded_vocab,
                    "finite logits over the padded vocabulary")
        out["used_peak"] = int(used.max())
        out["dense_final"] = int(dense[-1])
        out["engine"] = engine
        print(
            f"serve delta_cow={delta_cow}: prefill {SERVE_PROMPTS} x {SERVE_PROMPT_LEN} tokens "
            f"{prefill_s:.3f} s; {SERVE_TOKENS} tokens x {SERVE_SLOTS} rows in "
            f"{out['decode_s']:.3f} s ({out['decode_s'] / SERVE_TOKENS * 1e3:.2f} ms per token); "
            f"peak live pages {out['used_peak']} (dense {out['dense_final']}); "
            f"after compact {int(kvc.used_blocks(engine.cache))} pages; oom=False",
            flush=True,
        )
        return out

    dispatch.reset_launch_counts()
    whole = serve(False, eng)
    delta = serve(True)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"serve launches (both runs): {json.dumps(launches)}", flush=True)
    for op in ("paged_attention", "paged_attention_delta", "cow_gather"):
        require(launches[op] > 0, f"kernel {op} launched on the serving path ({launches[op]})")
    for a, b in zip(whole["logits"], delta["logits"], strict=True):
        require(torch.equal(a, b), "delta COW on and off give bit-identical logits at every step")
    for a, b in zip(whole["tokens"], delta["tokens"], strict=True):
        require(torch.equal(a, b), "delta COW on and off sample the same tokens")
    print(f"serve: delta COW on and off bit-identical over {len(whole['logits'])} logit sets "
          f"and {len(whole['tokens'])} token steps", flush=True)

    # Where a decode step's time goes (whole-page run, traced).
    engine = whole["engine"]
    tok = whole["tokens"][-1]
    torch.cuda.synchronize()
    before = dispatch.launch_counts()["paged_attention"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(SERVE_PROFILE_TOKENS):
            engine.decode(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traced = dispatch.launch_counts()["paged_attention"] - before
    summary = profile_summary(prof, wall * 1e3, SERVE_PROFILE_TOKENS, "token",
                              "paged_attention_kernel", traced)
    if summary["records_complete"]:  # the split kernel and its merge
        summary["paged_attention_ms_per_token"] = {
            name: sum(us for k, (us, _) in kernel_events(prof).items() if name in k)
            / 1e3 / SERVE_PROFILE_TOKENS
            for name in ("paged_attention_kernel", "paged_attention_combine")
        }
    print(json.dumps({"serve_profile": {
        "tokens": SERVE_PROFILE_TOKENS, "rows": SERVE_SLOTS, **summary,
    }}), flush=True)

    # -- 7. each paged-attention kernel against its plain version ----------
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    q = torch.randn((SERVE_SLOTS, cfg.n_heads, cfg.hd), generator=gen, device=dev).to(torch.bfloat16)
    for op, run, replaces in (
        ("paged_attention", whole, "src/repro/kernels/paged_attention/kernel.py:210"),
        ("paged_attention_delta", delta, "src/repro/kernels/paged_attention/kernel.py:142"),
    ):
        cache = run["engine"].cache
        kw = dict(parent=cache.pool.parent, dirty=cache.pool.dirty) if op.endswith("delta") else {}
        pages, splits = split_plan(SERVE_SLOTS, cfg.n_kv_heads, cache.tables.shape[1], SERVE_BLOCK)
        # Planted faults: the first page of split 1 dropped from every row;
        # every length one slot short.
        dropped = cache.tables.clone()
        dropped[:, pages] = -1
        planted = {"page dropped at a split edge": (dropped, cache.lengths),
                   "length one slot short": (cache.tables, cache.lengths - 1)}
        errs, faults = [], {name: 0.0 for name in planted}
        for layer in (0, cfg.n_layers - 1):
            k_pool, v_pool = kvc.layer_views(cache, layer)
            got = paged_attention(q, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            want = paged_attention_ref(q, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            errs.append((got.float() - want.float()).abs().max().item())
            require(torch.equal(got, paged_attention(q, k_pool, v_pool, cache.tables, cache.lengths, **kw)),
                    f"{op}: a repeat call is bit-equal to the first")
            for name, (tables, lengths) in planted.items():
                wrong = paged_attention_ref(q, k_pool, v_pool, tables, lengths, **kw)
                faults[name] = max(faults[name], (got.float() - wrong.float()).abs().max().item())
        err = max(errs)
        require(err <= 1e-2, f"{op}: bf16 kernel within atol 1e-2 of its plain version ({err})")
        for name, reading in faults.items():
            require(reading > 1e-2, f"{op}: planted fault ({name}) reads above atol 1e-2 ({reading})")
        k_pool, v_pool = kvc.layer_views(cache, cfg.n_layers - 1)
        args = (q, k_pool, v_pool, cache.tables, cache.lengths)
        ms = device_ms(lambda: paged_attention(*args, **kw))
        plain_ms = device_ms(lambda: paged_attention_ref(*args, **kw))
        call_ms = time_ms(lambda: paged_attention(*args, **kw))
        moved = paged_bytes(cache, bool(kw), cfg.n_heads)
        bytes_ms = moved / rate * 1e3
        # QK and PV: 4 flops per (query head, slot, element), bf16 inputs.
        ops_ms = 4 * cfg.n_heads * cfg.hd * int(cache.lengths.sum()) / BF16_RATE * 1e3
        rows.append({
            "name": op, "route": "cuda", "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[op], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call reads K/V through a block table",
            "call_ms": call_ms, "pages_per_split": pages, "splits": splits, "planted_faults": faults,
        })
        print(f"kernel {op}: {splits} splits of {pages} pages; repeat call bit-equal; planted faults "
              f"read {json.dumps(faults)} (limit 1e-2)", flush=True)
        print(f"kernel {op}: max |kernel - plain| {err!r} (layers 0 and {cfg.n_layers - 1}, bf16); "
              f"{ms:.4f} ms on the device, {call_ms:.4f} ms per call, plain {plain_ms:.4f} ms, "
              f"bound {max(bytes_ms, ops_ms):.4f} ms ({moved} bytes; operations {ops_ms:.4f} ms)",
              flush=True)

    # pool_compact at the serving page size (491,520-byte bf16 pages)
    data = whole["engine"].cache.pool.data
    perm = torch.randperm(data.shape[0] - 1, generator=gen, device=dev)[:64].to(torch.int32)
    require(torch.equal(pool_compact(data, perm)[:-1], cow_gather_ref(data, perm)),
            "cow_gather moves bf16 KV pages exactly")
    del whole, delta, engine, eng, weights, data
    torch.cuda.empty_cache()

    # -- 8. the smoke config on the card against the CPU path --------------
    readings, card = card_against_cpu(dev)
    # Both kernels on the smoke run's f32 pools, against the plain version.
    f32_err = 0.0
    for delta_cow, e in card.items():
        cache = e.cache
        kw = dict(parent=cache.pool.parent, dirty=cache.pool.dirty) if delta_cow else {}
        qs = torch.randn((cache.tables.shape[0], SMOKE.n_heads, SMOKE.hd), generator=gen, device=dev)
        for layer in range(SMOKE.n_layers):
            k_pool, v_pool = kvc.layer_views(cache, layer)
            got = paged_attention(qs, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            want = paged_attention_ref(qs, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            f32_err = max(f32_err, (got - want).abs().max().item())
    require(f32_err <= 1e-5, f"paged attention on f32 pools within atol 1e-5 ({f32_err})")
    print(f"smoke f32 run: card equals the CPU path (tables, refcounts, lengths); delta on/off "
          f"bit-identical; logits within {LOGIT_TOL} x the step's largest logit: "
          f"{json.dumps(readings)}; both kernels within {f32_err!r} of the plain version on "
          f"the f32 pools", flush=True)

    # -- 9. the serve entry point at full width ------------------------------
    dispatch.reset_launch_counts()
    toks = serve_cli.main(["--full"])
    torch.cuda.synchronize()
    cli_launches = dispatch.launch_counts()
    print(f"serve CLI --full launches: {json.dumps(cli_launches)}", flush=True)
    require(cli_launches["paged_attention"] > 0, "the serve CLI went through paged_attention")
    require(toks.shape == (4, 33) and bool(((toks >= 0) & (toks < CONFIG.padded_vocab)).all()),
            f"the serve CLI returns 4 continuations of 33 tokens in the vocabulary ({tuple(toks.shape)})")
    return rows


# Phase 12: SMC decoding through the continuous-batching scheduler at
# starcoder2-3b's full width: two requests of 16 particles in one engine of
# 32 rows (pages of 16 tokens, the automatic pool, growth on), prompts of
# 500 tokens, 64 steps each; the forced preemption's tick, the checkpoint's
# tick, and the request seeds.
SMC_PARTICLES = 16
SMC_REQUESTS = 2
SMC_SLOTS = SMC_PARTICLES * SMC_REQUESTS
SMC_PROMPT_LEN = 500
SMC_STEPS = 64
SMC_TARGET_TEMP, SMC_PROPOSAL_TEMP, SMC_ESS = 0.7, 1.0, 0.5
SMC_PREEMPT_AT = 20
SMC_CHECKPOINT_AT = 32
# The tick whose paged-attention calls (both requests live) are kept and
# held against the plain version, in whole-page and in delta mode.
SMC_ATTN_AT = 48
SMC_OPS = ("paged_attention", "clone_chain", "cow_write", "cow_gather")


def smc_decode_phase(dev, rows):
    """Phase 12: SMC decoding on the card through the scheduler, with its
    disturbances (preemption, faults on a forking tick, checkpoint and
    restore, delta COW) each bit-exact with the undisturbed run, and every
    kernel the path launches against its plain version on the path's own
    inputs: the token store's cow_write, clone_chain and final cow_gather,
    and one tick's paged attention in whole-page and in delta mode.  Adds
    the SMC path's launches to ``rows``; returns the model, its cast
    weights and the cache config, which phase 13 reuses."""
    import pickle

    from repro_torch.configs.starcoder2_3b import CONFIG
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
    from repro_torch.kernels.paged_attention.ops import split_plan
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.faults import FaultEvent, FaultInjector, FaultKind
    from repro_torch.serving.scheduler import DecodeRequest, Scheduler, SchedulerEventLog
    from repro_torch.smc import executor as executor_lib

    cfg = CONFIG
    lm = LanguageModel(cfg)
    t = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    # The embedding table is drawn by the model's law (std 1), then scaled by
    # 1/sqrt(d_model) (std 0.018 at full width).  As drawn, the input token's
    # logit is ~550 against ~250 for the best other (the tied table's |e|^2
    # over the final norm): the proposal is one-hot, every particle repeats
    # its input token, the weights never move and no request resamples
    # (PERF.md §6).  Scaled, the first logits have std ~1 and an entropy of
    # ~10.3 nats, and the population diverges.  The phase prints both.
    drawn = params["embed"].clone()
    params["embed"].mul_(1.0 / math.sqrt(cfg.d_model))
    ccfg = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=SERVE_BLOCK, max_seqs=SMC_SLOTS,
        max_blocks_per_seq=-(-(SMC_PROMPT_LEN + SMC_STEPS + 16) // SERVE_BLOCK), dtype=cfg.dtype,
    )
    first = ServeEngine(lm, params, ccfg, device=dev)
    weights = first.params  # matrices cast to bf16 once, shared by every engine
    del params
    torch.cuda.synchronize()
    print(f"smc: weights drawn and cast in {time.perf_counter() - t:.1f} s; {SMC_SLOTS} rows, "
          f"pool {ccfg.pool_blocks} pages (automatic size) of "
          f"{first.cache.pool.data[0].numel() * 2} bytes", flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (SMC_REQUESTS, SMC_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 20), device=dev)
    rids = [f"r{i}" for i in range(SMC_REQUESTS)]

    def request(i):
        return DecodeRequest(
            rid=rids[i], prompt=prompts[i], n_particles=SMC_PARTICLES, steps=SMC_STEPS,
            gen=torch.Generator(device=dev).manual_seed(SEED + 21 + i),
            target_temp=SMC_TARGET_TEMP, proposal_temp=SMC_PROPOSAL_TEMP, ess_threshold=SMC_ESS,
        )

    def engine(delta_cow=False):
        return ServeEngine(lm, weights, kvc.KVCacheConfig(**{**vars(ccfg), "delta_cow": delta_cow}),
                           device=dev)

    def nbytes(tree) -> int:
        sizes = []
        executor_lib.tree_map(
            lambda x: sizes.append(x.numel() * x.element_size()) if torch.is_tensor(x) else None, tree)
        return sum(sizes)

    def schedule(reqs, eng=None, **kw):
        sched = Scheduler(eng or engine(), **kw)
        for r in reqs:
            sched.submit(r)
        return sched

    def same(got, want, what):
        for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"):
            require(torch.equal(getattr(got, f), getattr(want, f)), f"{what}: {f} bit-equal")

    def timed_ticks(sched) -> list:
        """Drive ``sched`` to the end; the wall seconds of each tick."""
        walls = []
        while True:
            t = time.perf_counter()
            more = sched.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not more:
                return walls

    # -- the main path: both requests, counters from 0 ----------------------
    log = SchedulerEventLog()
    sched = schedule([request(i) for i in range(SMC_REQUESTS)], eng=first, event_log=log)
    del first
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    walls = timed_ticks(sched)
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    main = sched.results
    ticks = sched.stats.ticks
    for op in SMC_OPS:
        require(launches[op] > 0, f"kernel {op} launched on the SMC-decode path ({launches[op]})")
    dense = SMC_REQUESTS * SMC_PARTICLES * -(-(SMC_PROMPT_LEN + SMC_STEPS) // SERVE_BLOCK)
    peak = log.peak_blocks()
    for rid in rids:
        res = main[rid]
        require(res.status == "ok" and not bool(res.oom), f"{rid}: ok, oom False")
        require(bool(res.resampled.any()), f"{rid}: resampled at least once ({res.ess_trace.tolist()})")
        require(tuple(res.tokens.shape) == (SMC_PARTICLES, SMC_STEPS)
                and bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()),
                f"{rid}: tokens in the vocabulary")
        require(math.isfinite(float(res.log_evidence)) and bool(torch.isfinite(res.ess_trace).all()),
                f"{rid}: finite log-evidence and ESS")
    require(peak < dense, f"peak KV pages {peak} below the dense count {dense}")
    print(f"smc main: {ticks} ticks in {wall_s:.2f} s; per tick median "
          f"{sorted(walls)[len(walls) // 2] * 1e3:.2f} ms; resamples "
          f"{[int(main[r].resampled.sum()) for r in rids]}; peak {peak} pages (dense {dense}); "
          f"grew {sched.executor.stats.grow_events}; launches {json.dumps(launches)}", flush=True)

    # -- the rollback snapshot end to end: the schedule with an empty fault
    # injector (a snapshot every tick) and without one, alternated --------
    snapshot_walls = {"with": [], "without": []}
    for kind in ("with", "without", "without", "with"):
        sched = schedule([request(i) for i in range(SMC_REQUESTS)],
                         faults=FaultInjector([]) if kind == "with" else None)
        ticked = timed_ticks(sched)
        snapshot_walls[kind].append(sorted(ticked)[len(ticked) // 2] * 1e3)
        for rid in rids:
            same(sched.results[rid], main[rid], f"{rid}, {kind} the rollback snapshot")
    print(f"smc: median wall per tick with a snapshot every tick / without, alternated: "
          f"{json.dumps(snapshot_walls)} ms", flush=True)

    # -- why the embedding is scaled: the first step's proposal, and the
    # same run with the table as drawn --------------------------------------
    def proposal(eng):
        logits = eng.prefill(prompts[:1], torch.zeros(1, dtype=torch.int32, device=dev))[0]
        p = torch.softmax(logits / SMC_PROPOSAL_TEMP, dim=-1)
        return {"top_prob": p.max().item(), "entropy_nats": -torch.xlogy(p, p).sum().item(),
                "logit_std": logits.std().item()}

    as_drawn = {**weights, "embed": drawn}
    first_step = {"scaled": proposal(engine()), "as_drawn": proposal(
        ServeEngine(lm, as_drawn, ccfg, device=dev))}
    res = schedule([request(i) for i in range(SMC_REQUESTS)],
                   eng=ServeEngine(lm, as_drawn, ccfg, device=dev)).run()
    resamples_as_drawn = {rid: int(res[rid].resampled.sum()) for rid in rids}
    del as_drawn, drawn
    print(f"smc: the first step's proposal {json.dumps(first_step)}; resamples with the "
          f"table as drawn {json.dumps(resamples_as_drawn)}", flush=True)

    # -- each request alone, on an engine of the same 32 rows ---------------
    for i, rid in enumerate(rids):
        same(schedule([request(i)]).run()[rid], main[rid], f"{rid} alone on {SMC_SLOTS} rows")
    print(f"smc: each request alone on an engine of {SMC_SLOTS} rows is bit-exact with the "
          "two-request run", flush=True)

    # -- a forced preemption at tick 20 and its resume; the inputs of the
    # token store's last cow_write, clone_chain and cow_gather calls kept --
    captured = {}

    def preempt_once(s):
        if s.tick == SMC_PREEMPT_AT and not s.stats.preemptions:
            s.preempt(rids[-1])

    sched = schedule([request(i) for i in range(SMC_REQUESTS)], on_boundary=preempt_once)
    with token_store_calls(captured):
        res = sched.run()
    require(sched.stats.preemptions == 1 and sched.stats.replayed_tokens == SMC_PREEMPT_AT,
            f"one preemption at tick {SMC_PREEMPT_AT}, {SMC_PREEMPT_AT} tokens replayed")
    for rid in rids:
        same(res[rid], main[rid], f"{rid} with a preemption at tick {SMC_PREEMPT_AT}")
    print(f"smc: preempted {rids[-1]} at tick {SMC_PREEMPT_AT} and resumed: bit-exact", flush=True)

    print(f"smc: {check_token_store_calls(captured, 'smc')} equal their plain versions", flush=True)

    # One tick's paged-attention calls, kept from the next two runs (layer 0
    # and the last layer), with what the path computed.
    attn = {"tick": None, "calls": []}
    attention = engine_lib.paged_attention

    def note_tick(s):
        attn["tick"] = s.tick

    def capture_attention(q, k_pool, v_pool, tables, lengths, **kw):
        out = attention(q, k_pool, v_pool, tables, lengths, **kw)
        if attn["tick"] == SMC_ATTN_AT:
            kv = torch.stack([k_pool, v_pool], 1).clone()  # [rows, 2, bs, KVH, hd]
            attn["calls"].append((q.clone(), kv, tables.clone(), lengths.clone(),
                                  {k: v.clone() for k, v in kw.items()}, out.clone()))
            del attn["calls"][1:-1]  # the first call and the latest
        return out

    def check_attention(mode):
        calls, attn["calls"], attn["tick"] = attn["calls"], [], None
        require(len(calls) == 2, f"{mode}: tick {SMC_ATTN_AT}'s paged-attention calls kept")
        errs = []
        for q, kv, tables, lengths, kw, out in calls:
            args = (q, kv[:, 0], kv[:, 1], tables, lengths)
            require(torch.equal(paged_attention(*args, **kw), out),
                    f"{mode}: a repeat call is bit-equal to the path's")
            errs.append((out.float() - paged_attention_ref(*args, **kw).float()).abs().max().item())
        err = max(errs)
        require(err <= 1e-2, f"{mode}: bf16 kernel within atol 1e-2 of its plain version ({err})")
        q, kv, tables, lengths, kw, _ = calls[0]
        pages, splits = split_plan(q.shape[0], kv.shape[3], tables.shape[1], SERVE_BLOCK)
        return {"max_abs_err": err, "rows": q.shape[0], "pages_per_split": pages, "splits": splits,
                "slots_read": int(lengths.sum()),
                **({"delta_pages": int((kw["parent"] >= 0).sum())} if kw else {})}

    # -- STEP_FAILURE then OOM on a tick that forks -------------------------
    fork = min(int(torch.nonzero(main[rid].resampled)[0]) for rid in rids)
    inj = FaultInjector([FaultEvent(FaultKind.STEP_FAILURE, tick=fork),
                         FaultEvent(FaultKind.OOM, tick=fork, repeats=2)])
    require(fork < SMC_ATTN_AT, f"the fault's tick {fork} lies before tick {SMC_ATTN_AT}")
    sched = schedule([request(i) for i in range(SMC_REQUESTS)], faults=inj, on_boundary=note_tick)
    engine_lib.paged_attention = capture_attention
    try:
        res = sched.run()
    finally:
        engine_lib.paged_attention = attention
    require(sched.stats.retries == 2 and sched.check_invariants() == [],
            "two rolled-back attempts, invariants clean")
    for rid in rids:
        require(not bool(res[rid].oom), f"{rid}: the rollback cleared the forced oom")
        same(res[rid], main[rid], f"{rid} with STEP_FAILURE and OOM at tick {fork}")
    print(f"smc: STEP_FAILURE then OOM at tick {fork} (a fork) rolled back twice: bit-exact", flush=True)
    attention_check = {"paged_attention": check_attention("paged_attention")}

    # -- checkpoint at tick 32, restore on a fresh engine; the rollback
    # snapshot's cost on that tick's state (a scheduler takes it on every
    # tick when it has a fault injector, on none without one) -------------
    saved = {}

    class Kill(Exception):
        pass

    def checkpoint_at(s):
        if s.tick == SMC_CHECKPOINT_AT and not saved:
            snap = s._snapshot()
            saved["bytes"] = nbytes([snap["cache"]] + [r[6] for r in snap["reqs"]])
            del snap
            saved["snapshot_ms"] = device_ms(s._snapshot, reps=10)
            saved["state"] = pickle.loads(pickle.dumps(s.checkpoint()))
            raise Kill

    sched = schedule([request(i) for i in range(SMC_REQUESTS)], on_boundary=checkpoint_at)
    try:
        sched.run()
    except Kill:
        pass
    require("state" in saved, f"a checkpoint at tick {SMC_CHECKPOINT_AT}")
    res = Scheduler.restore(engine(), saved.pop("state"), watchdog=True).run()
    for rid in rids:
        same(res[rid], main[rid], f"{rid} restored from the checkpoint at tick {SMC_CHECKPOINT_AT}")
    print(f"smc: checkpoint at tick {SMC_CHECKPOINT_AT}, restore on a fresh engine: bit-exact; "
          f"the rollback snapshot, taken on every tick under a fault injector, copies "
          f"{saved['bytes']} bytes in {saved['snapshot_ms']:.4f} ms on the device", flush=True)

    # -- delta COW: the same run, bit-identical -----------------------------
    dispatch.reset_launch_counts()
    engine_lib.paged_attention = capture_attention
    try:
        res = schedule([request(i) for i in range(SMC_REQUESTS)], eng=engine(delta_cow=True),
                       on_boundary=note_tick).run()
    finally:
        engine_lib.paged_attention = attention
    torch.cuda.synchronize()
    delta_launches = dispatch.launch_counts()
    attention_check["paged_attention_delta"] = check_attention("paged_attention_delta")
    require(delta_launches["paged_attention_delta"] > 0,
            f"kernel paged_attention_delta launched ({delta_launches['paged_attention_delta']})")
    for rid in rids:
        same(res[rid], main[rid], f"{rid} with kv_delta_cow=True")
    print(f"smc: kv_delta_cow=True bit-identical; launches {json.dumps(delta_launches)}", flush=True)
    print(f"smc: tick {SMC_ATTN_AT}'s paged attention (layers 0 and {cfg.n_layers - 1}) against the "
          f"plain version, limit 1e-2: {json.dumps(attention_check)}", flush=True)

    # -- the entry points on the card -----------------------------------------
    res = serve_cli.main(["--smc", "--steps", "12"])
    require(not bool(res.oom) and tuple(res.tokens.shape) == (16, 12), "serve --smc on the card")

    per_tick = {op: launches[op] / ticks for op in SMC_OPS}
    per_tick["paged_attention_delta"] = delta_launches["paged_attention_delta"] / ticks
    counts = {**{op: launches[op] for op in SMC_OPS},
              "paged_attention_delta": delta_launches["paged_attention_delta"]}
    for row in rows:
        if row["name"] in counts:
            row["smc_decode_launches"] = counts[row["name"]]
    print(json.dumps({"smc_decode": {
        "model": "starcoder2-3b", "requests": SMC_REQUESTS, "particles": SMC_PARTICLES,
        "rows": SMC_SLOTS, "prompt_len": SMC_PROMPT_LEN, "steps": SMC_STEPS,
        "ticks": ticks, "wall_ms_per_tick_median": sorted(walls)[len(walls) // 2] * 1e3,
        "wall_ms_per_tick_min": min(walls) * 1e3, "wall_s": wall_s,
        "launches_per_tick": per_tick, "launches": counts,
        "resamples": {rid: int(main[rid].resampled.sum()) for rid in rids},
        "resamples_embedding_as_drawn": resamples_as_drawn, "first_step_proposal": first_step,
        "peak_pages": peak, "dense_pages": dense,
        "grow_events": sum(1 for e in log.events if e[0] == "grow"),
        "snapshot_bytes_per_tick": saved["bytes"], "snapshot_device_ms_per_tick": saved["snapshot_ms"],
        "snapshot_taken": "on every tick under a fault injector, on none without one",
        "wall_ms_per_tick_median_with_and_without_snapshot": snapshot_walls,
        "paged_attention_against_plain": attention_check,
        "fork_tick_faulted": fork,
    }}), flush=True)
    return lm, weights, ccfg


@contextlib.contextmanager
def token_store_calls(captured: dict):
    """While open, the store's ``cow_write``, ``clone_chain`` and
    ``cow_gather`` keep their latest call's inputs (``cow_gather`` its
    output too) in ``captured``; the SMC token store is their caller."""
    from repro_torch import random as rnd
    from repro_torch.core import store as store_lib
    from repro_torch.kernels.clone_chain import weights_cdf

    store_write, store_chain, store_gather = (
        store_lib.cow_write, store_lib.clone_chain_op, store_lib.cow_gather)

    def capture_write(data, src, dst, pos, values):
        captured["cow_write"] = (data.clone(), src.clone(), dst.clone(), pos.clone(), values.clone())
        return store_write(data, src, dst, pos, values)

    def capture_chain(gen, logw, tables, *, num_blocks):
        # The uniform the chain is about to draw, from a copy of its generator.
        u = rnd.uniform(rnd.snapshot(gen), ()).to(logw.device)
        captured["clone_chain"] = (weights_cdf(logw), u, tables.clone(), num_blocks)
        return store_chain(gen, logw, tables, num_blocks=num_blocks)

    def capture_gather(data, table, out=None):
        got = store_gather(data, table, out)
        captured["cow_gather"] = (data.clone(), table.clone(), got.clone())
        return got

    store_lib.cow_write, store_lib.clone_chain_op, store_lib.cow_gather = (
        capture_write, capture_chain, capture_gather)
    try:
        yield captured
    finally:
        store_lib.cow_write, store_lib.clone_chain_op, store_lib.cow_gather = (
            store_write, store_chain, store_gather)


def check_token_store_calls(captured: dict, what: str) -> str:
    """The token store's kept ``cow_write``, ``clone_chain`` and final
    ``cow_gather`` (``token_store_calls``) against their plain versions,
    exact; returns what was checked, for the log."""
    from repro_torch.kernels.clone_chain import clone_chain_kernel, clone_chain_ref
    from repro_torch.kernels.cow_gather import cow_gather, cow_gather_ref
    from repro_torch.kernels.cow_write import cow_write, cow_write_ref

    data, src, dst, pos, values = captured.pop("cow_write")
    require(data.dtype == torch.int32 and data.dim() == 2 and values.dim() == 1,
            f"{what}: the token store's pool is int32 with items () ({data.dtype}, {tuple(data.shape)})")
    got = cow_write(data.clone(), src, dst, pos, values)
    want = cow_write_ref(data.clone(), src, dst, pos, values)
    require(torch.equal(got[:-1], want[:-1]) and not got[-1].any(),
            f"{what}: cow_write equals its plain version at the token store's shapes")
    pool, rows = tuple(data.shape), src.shape[0]
    cum, u, tables, nb = captured.pop("clone_chain")
    got = clone_chain_kernel(cum, u, tables, nb)
    want = clone_chain_ref(cum, u, tables, nb)
    require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
            f"{what}: clone_chain equals its plain version at the token store's shapes")
    data, table, out = captured.pop("cow_gather")
    require(data.dtype == torch.int32 and data.dim() == 2,
            f"{what}: the last cow_gather read the token store ({data.dtype}, {tuple(data.shape)})")
    require(torch.equal(out, cow_gather_ref(data, table)) and torch.equal(cow_gather(data, table), out),
            f"{what}: the token store's final cow_gather equals its plain version, and a repeat call")
    return (f"cow_write (int32 pool {pool}, {rows} rows), clone_chain ({tables.shape[0]} x "
            f"{tables.shape[1]} tables, {nb} blocks) and the final cow_gather ({table.shape[0]} blocks)")


# Phase 13: an SMC fleet.  The trace's requests (phase 12's sizes) arrive
# FLEET_INTERVAL ticks apart; replica 1's first paged-attention call (layer
# 0) of its tick FLEET_ATTN_AT, both of its requests live, is kept.
FLEET_REQUESTS = 4
FLEET_INTERVAL = 8
FLEET_ATTN_AT = 48


def fleet_phase(dev, rows, lm, weights, ccfg) -> None:
    """Phase 13: an SMC fleet on the card.  A trace of FLEET_REQUESTS
    requests through a 2-replica fleet (fleet A, driven through
    ``Router.stream()``, the counters set to 0 just before and read just
    after) and a 1-replica fleet (fleet B) of the same ``max_seqs``, each
    replica a ``Scheduler`` over its own ``ServeEngine`` on phase 12's
    weights.  Checks: results bit-equal between the fleets; A places on
    both replicas, B queues; the stream rebuilds A's tokens; every
    scheduler's log replays decision-exact through the simulator, its time
    within +/-25%; A's router log from ``simulate_router``; one tick's
    paged attention on replica 1 against its plain version.  Adds the
    fleet's launches to ``rows``."""
    from repro_torch.configs.starcoder2_3b import CONFIG
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import traces
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.router import Router, RouterEventLog, make_replicas
    from repro_torch.serving.scheduler import Scheduler, SchedulerEventLog, stream_tokens
    from repro_torch.serving.sim import CostModel, first_divergence, simulate, simulate_router

    trace = traces.staggered(FLEET_REQUESTS, FLEET_INTERVAL, n_particles=SMC_PARTICLES,
                             steps=SMC_STEPS, plen=SMC_PROMPT_LEN, seed=SEED)
    reqs = traces.to_decode_requests(trace, CONFIG.vocab_size, target_temp=SMC_TARGET_TEMP,
                                     device=dev)
    require(all((r.proposal_temp, r.ess_threshold) == (SMC_PROPOSAL_TEMP, SMC_ESS) for r in reqs),
            "the fleet's requests decode at phase 12's temperatures and ESS threshold")
    rids = [r.rid for r in reqs]
    # Replica 1's first paged-attention call of its tick FLEET_ATTN_AT.
    attn = {"on": False, "call": None, "live": None}
    attention = engine_lib.paged_attention

    def capture_attention(q, k_pool, v_pool, tables, lengths, **kw):
        out = attention(q, k_pool, v_pool, tables, lengths, **kw)
        if attn["on"] and attn["call"] is None:
            attn["call"] = (q.clone(), k_pool.clone(), v_pool.clone(), tables.clone(),
                            lengths.clone(), {k: v.clone() for k, v in kw.items()}, out.clone())
        return out

    def fleet(n, capture=False):
        logs = []

        def build(i, d):
            log = SchedulerEventLog()
            logs.append(log)
            eng = ServeEngine(lm, weights, ccfg, device=d)
            sched = Scheduler(eng, event_log=log)
            if capture and i == 1:
                decode = eng.decode

                def noted_decode(*args, **kw):
                    attn["on"] = sched.tick == FLEET_ATTN_AT
                    if attn["on"]:
                        attn["live"] = [s.req.rid for s in sched._active]
                    try:
                        return decode(*args, **kw)
                    finally:
                        attn["on"] = False

                eng.decode = noted_decode
            return sched

        scheds, devs = make_replicas(build, n=n, devices=[dev])
        router = Router(scheds, placement="least_loaded", event_log=RouterEventLog(), devices=devs)
        for r in reqs:
            router.submit(r)
        return router, logs

    # -- the main path: fleet A through Router.stream(), counters from 0 ---
    a, a_logs = fleet(2, capture=True)
    torch.cuda.synchronize()
    engine_lib.paged_attention = capture_attention
    dispatch.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        events = list(a.stream())
        torch.cuda.synchronize()
        a_wall = time.perf_counter() - t0
    finally:
        engine_lib.paged_attention = attention
    launches = dispatch.launch_counts()
    for op in SMC_OPS:
        require(launches[op] > 0, f"kernel {op} launched on the fleet path ({launches[op]})")
    res_a = a.results
    placements = {e[1]: e[3] for e in a.event_log.events if e[0] == "place"}
    require(sorted(res_a) == sorted(rids), f"fleet A served every request ({sorted(res_a)})")
    require(set(placements.values()) == {0, 1}, f"fleet A placed on both replicas ({placements})")

    # -- fleet B: one replica of the same max_seqs ---------------------------
    b, b_logs = fleet(1)
    t0 = time.perf_counter()
    res_b = b.run()
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    lat_a, lat_b = a.event_log.latency_rounds(), b.event_log.latency_rounds()
    require(lat_b["queue_p99"] > 0, f"fleet B queued a request ({lat_b})")
    for rid in rids:
        ra, rb = res_a[rid], res_b[rid]
        require(ra.status == rb.status == "ok" and not bool(ra.oom), f"{rid}: ok, oom False")
        for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"):
            require(torch.equal(getattr(ra, f), getattr(rb, f)),
                    f"{rid}: {f} bit-equal between 2 replicas and 1")
    resamples = {rid: int(res_a[rid].resampled.sum()) for rid in rids}
    require(sum(resamples.values()) > 0, f"a request resampled ({resamples})")

    # -- the stream rebuilds fleet A's tokens -----------------------------
    for r in reqs:
        evs = [ev for ev in events if ev.rid == r.rid]
        require(bool(evs) and evs[-1].final and evs[-1].status == "ok",
                f"{r.rid}: the stream ends with its final marker")
        rebuilt = stream_tokens(evs, n=r.n_particles, steps=r.steps)
        require(np.array_equal(rebuilt, res_a[r.rid].tokens.cpu().numpy()),
                f"{r.rid}: tokens rebuilt from the stream equal its result")

    # -- every scheduler's log replays through the simulator ---------------
    replays = {}
    for label, fleet_, logs in (("A", a, a_logs), ("B", b, b_logs)):
        for i, log in enumerate(logs):
            sched = fleet_.replicas[i].scheduler
            res = simulate(log.to_trace(f"{label}{i}"), ccfg, CostModel.from_event_log(log))
            div = first_divergence(log.decisions, res.decisions)
            require(div is None, f"fleet {label} replica {i}: decision-exact replay ({div})")
            require(res.peak_blocks == log.peak_blocks(),
                    f"fleet {label} replica {i}: peak pages {res.peak_blocks} == {log.peak_blocks()}")
            require(res.stats.as_dict() == sched.stats.as_dict(),
                    f"fleet {label} replica {i}: SchedulerStats equal")
            ratio = res.sim_time_s / log.recorded_wall_s()
            require(0.75 <= ratio <= 1.25,
                    f"fleet {label} replica {i}: simulated / recorded time {ratio} in [0.75, 1.25]")
            replays[f"{label}{i}"] = {"sim_over_recorded": ratio, "peak_pages": log.peak_blocks(),
                                      "ticks": sched.stats.ticks,
                                      "step_ms_median": float(np.median(log.step_wall_s)) * 1e3,
                                      "recorded_wall_s": log.recorded_wall_s()}
    recorded = {r.rid: r for log in a_logs for r in log.to_trace().requests}
    union = traces.Trace(name="fleet", requests=tuple(recorded[rid] for rid in rids))
    sim_a = simulate_router(union, ccfg, CostModel.from_event_log(a_logs[0]), n_replicas=2,
                            placement="least_loaded")
    require(sim_a.event_log.events == a.event_log.events,
            "fleet A's router log equals simulate_router's over its replicas' recorded traces")

    # -- replica 1's paged attention at tick FLEET_ATTN_AT -----------------
    require(attn["call"] is not None and len(attn["live"] or []) == 2,
            f"replica 1's tick {FLEET_ATTN_AT}: a paged-attention call kept, two requests live "
            f"({attn['live']})")
    q, k_pool, v_pool, tables, lengths, kw, out = attn.pop("call")
    args = (q, k_pool, v_pool, tables, lengths)
    require(torch.equal(paged_attention(*args, **kw), out), "fleet: a repeat call is bit-equal")
    attn_err = (out.float() - paged_attention_ref(*args, **kw).float()).abs().max().item()
    require(attn_err <= 1e-2, f"fleet: bf16 kernel within atol 1e-2 of its plain version ({attn_err})")
    del q, k_pool, v_pool, tables, lengths, kw, out, args

    steps_a = [w for log in a_logs for w in log.step_wall_s]
    tick_ms = float(np.median(steps_a)) * 1e3
    roof_ms = CostModel.from_roofline(CONFIG, ccfg, plen=SMC_PROMPT_LEN).step_s * 1e3
    for row in rows:
        if row["name"] in SMC_OPS:
            row["fleet_launches"] = launches[row["name"]]
    print(json.dumps({"fleet": {
        "model": "starcoder2-3b", "trace": trace.name, "requests": len(rids),
        "particles": SMC_PARTICLES, "steps": SMC_STEPS, "prompt_len": SMC_PROMPT_LEN,
        "rows_per_replica": ccfg.max_seqs, "pool_pages_per_replica": ccfg.pool_blocks,
        "placement": a.placement_name, "placements": placements,
        "rounds": {"A": a.round, "B": b.round}, "wall_s": {"A": a_wall, "B": b_wall},
        "latency_rounds": {"A": lat_a, "B": lat_b},
        "utilization": {"A": a.utilization(), "B": b.utilization()},
        "replicas": replays, "resamples": resamples, "stream_events": len(events),
        "tick_ms_median": tick_ms, "roofline_step_ms": roof_ms,
        "tick_over_roofline": tick_ms / roof_ms, "launches": {op: launches[op] for op in SMC_OPS},
        "paged_attention_against_plain": {"max_abs_err": attn_err, "tick": FLEET_ATTN_AT,
                                          "live": attn["live"]},
    }}), flush=True)


def write_bytes(data, src, dst, pos, keep=None) -> torch.Tensor:
    """Bytes one COW write must move (a 0-dim device tensor): the ids of
    every row (and its keep bytes); for each row not on the dump row, its
    value, the source items it keeps (all but the written one for the
    whole-block write; the kept ones but the written one under delta), and
    the block it writes."""
    nb, bs = data.shape[0] - 1, data.shape[1]
    item = data[0, 0].numel() * data.element_size()
    live = dst != nb
    if keep is None:
        kept = torch.full_like(dst, bs - 1)
    else:
        slot = torch.arange(bs, device=dst.device)[None, :]
        kept = (keep.bool() & (slot != pos[:, None].long())).sum(1)
    per_row = torch.where(live, item + kept * item + bs * item, 0).long()
    meta = dst.numel() * (12 + (0 if keep is None else keep.shape[1] * keep.element_size()))
    return per_row.sum() + meta


def delta_store_phase(dev, rate, ys):
    """Phase 10: the store's sub-block delta COW at the filter's scale,
    against the whole-block store on the same draws.  Returns the
    ``cow_write_delta`` row."""
    from repro_torch import random as rnd
    from repro_torch.core import pool as pool_lib
    from repro_torch.core import store as store_lib
    from repro_torch.core.config import CopyMode
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_write import cow_write_delta, cow_write_delta_ref

    n, steps = N_PARTICLES, N_STEPS
    ys_t = torch.as_tensor(ys, device=dev)
    mid_pos = (0, DELTA_MID // 2, DELTA_MID - 3, DELTA_MID - 1)
    end_pos = (0, steps // 2 + 1, steps - 5, steps - 1)
    captured = {}
    moved = {}
    writers = {name: getattr(store_lib, name) for name in ("cow_write", "cow_write_delta")}

    def counting(name):
        # Sums the bytes each call must move, on the device (no sync), and
        # keeps the arguments of the last call for the kernel check below.
        def wrapped(data, src, dst, pos, values, *keep):
            moved[name] = moved.get(name, 0) + write_bytes(data, src, dst, pos, *keep)
            captured[name] = (src, dst, pos, values, *keep)
            return writers[name](data, src, dst, pos, values, *keep)
        return wrapped

    def valid_prefix(cfg, store):
        trajs = store_lib.materialize_batch(cfg, store, torch.arange(n, device=dev))
        live = torch.arange(cfg.capacity, device=dev)[None, :] < store.lengths[:, None]
        return torch.where(live[..., None], trajs, 0.0)

    def run(delta):
        cfg = store_lib.StoreConfig(
            mode=CopyMode.LAZY_SR, n=n, block_size=DELTA_BLOCK,
            max_blocks=-(-steps // DELTA_BLOCK), item_shape=(1,), delta_cow=delta,
        )
        store = store_lib.create(cfg, device=dev)
        gen = rnd.generator(SEED + 10, dev)
        x = rnd.normal(gen, (n,))
        logw = None
        delta_blocks = torch.zeros((), dtype=torch.int64, device=dev)
        out = {"cfg": cfg, "wall_s": 0.0}
        for name, fn in writers.items():
            setattr(store_lib, name, counting(name))
        moved.clear()
        prof = None
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for step in range(steps):
                if delta and step == DELTA_MID:
                    # Trace TRACE_GENS generations (mid-block: delta blocks live).
                    torch.cuda.synchronize()
                    out["wall_s"] += time.perf_counter() - t
                    counted = dispatch.launch_counts()
                    tracer = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                    tracer.start()
                    prof = tracer
                    t_trace = time.perf_counter()
                if logw is not None:
                    store, anc = store_lib.clone_chain(cfg, store, gen, logw)
                    x = x[anc.long()]
                x = A * x + math.sqrt(Q) * rnd.normal(gen, (n,))
                logw = -0.5 * ((ys_t[step] - x) ** 2 / R + math.log(2 * math.pi * R))
                store = store_lib.append(cfg, store, x[:, None])
                delta_blocks = torch.maximum(delta_blocks, (store.pool.parent >= 0).sum())
                if step + 1 == DELTA_MID:
                    torch.cuda.synchronize()
                    out["wall_s"] += time.perf_counter() - t
                    out["mid"] = valid_prefix(cfg, store)
                    out["mid_reads"] = [store_lib.read_at(cfg, store, p) for p in mid_pos]
                    if delta:
                        out["routing"] = captured["cow_write_delta"]
                        out["mid_delta_blocks"] = int((store.pool.parent >= 0).sum())
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                if prof is not None and step == DELTA_MID + TRACE_GENS - 1:
                    torch.cuda.synchronize()
                    traced_ms = (time.perf_counter() - t_trace) * 1e3
                    prof.stop()
                    after = dispatch.launch_counts()
                    out["trace"] = (prof, {k: after[k] - counted[k] for k in after}, traced_ms)
                    prof = None
                    t = time.perf_counter()
            torch.cuda.synchronize()
            out["wall_s"] += time.perf_counter() - t
        finally:
            if prof is not None:
                prof.stop()
            for name, fn in writers.items():
                setattr(store_lib, name, fn)
        name = "cow_write_delta" if delta else "cow_write"
        out["bytes_per_append"] = int(moved[name]) / steps
        out["final"] = valid_prefix(cfg, store)
        out["reads"] = [store_lib.read_at(cfg, store, p) for p in end_pos]
        out["store"] = store
        out["delta_blocks"] = int(delta_blocks)
        require(not bool(store_lib.oom_flag(cfg, store)), f"delta_cow={delta}: oom is False")
        require(bool(pool_lib.free_stack_consistent(store.pool)), f"delta_cow={delta}: free stack consistent")
        require(bool(pool_lib.refcount_matches_tables(store.pool, store.tables)),
                f"delta_cow={delta}: refcounts match the tables and parents")
        print(
            f"delta store delta_cow={delta} N={n} T={steps} block_size={DELTA_BLOCK}: "
            f"wall_s={out['wall_s']:.3f} ({out['wall_s'] / steps * 1e3:.3f} ms per generation) "
            f"peak_blocks={int(store.peak_blocks)} pool_blocks={store.pool.num_blocks} "
            f"most delta blocks live={out['delta_blocks']} "
            f"{name} bytes per append {out['bytes_per_append']:.1f} oom=False",
            flush=True,
        )
        return out

    dispatch.reset_launch_counts()
    whole = run(False)
    delta = run(True)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"delta store launches (both runs): {json.dumps(launches)}", flush=True)
    for op in ("cow_write", "cow_write_delta", "clone_chain", "cow_gather"):
        require(launches[op] > 0, f"kernel {op} launched on the delta store's path ({launches[op]})")
    require(delta["delta_blocks"] > 0 and delta["mid_delta_blocks"] > 0,
            f"delta blocks were made ({delta['delta_blocks']}, {delta['mid_delta_blocks']} mid-block)")
    require(whole["delta_blocks"] == 0, "the whole-block store makes no delta blocks")
    for key in ("mid", "final"):
        require(torch.equal(whole[key], delta[key]),
                f"{key}: materialize_batch of all N equal with delta COW on and off")
    for a, b in zip(whole["mid_reads"] + whole["reads"], delta["mid_reads"] + delta["reads"], strict=True):
        require(torch.equal(a, b), "read_at equal with delta COW on and off")
    print(f"delta store: delta COW on and off bit-equal at N={n} (materialize_batch mid-block at "
          f"{DELTA_MID} and at {steps} items, read_at at 8 positions); bytes per append: "
          f"cow_write {whole['bytes_per_append']:.1f}, cow_write_delta {delta['bytes_per_append']:.1f}",
          flush=True)
    # Launches per generation of the delta run: the counted ones, and every
    # device kernel in the traced window; one cow_write_delta_kernel
    # record per counted launch (the dump row is zeroed in that launch).
    prof, counted, traced_ms = delta["trace"]
    summary = profile_summary(prof, traced_ms, TRACE_GENS, "generation", "cow_write_delta_kernel",
                              counted["cow_write_delta"])
    print(json.dumps({"delta_profile": {
        "N": n, "generations": f"{DELTA_MID}-{DELTA_MID + TRACE_GENS - 1}",
        "counted_launches_per_generation": {k: v / TRACE_GENS for k, v in counted.items() if v},
        **summary,
    }}), flush=True)
    if kernel_events(prof):  # CUPTI delivered records
        require(summary["records_complete"],
                f"one cow_write_delta_kernel record per counted launch ({summary})")

    # cow_write_delta against its plain version, on the mid-block append's
    # own routing (copy rows keeping their dirty slots, copy rows keeping
    # none, in-place rows) over the delta run's final pool.
    src, dst, pos, values, keep = delta["routing"]
    data = delta["store"].pool.data
    nb = data.shape[0] - 1
    got = cow_write_delta(data.clone(), src, dst, pos, values, keep)
    want = cow_write_delta_ref(data.clone(), src, dst, pos, values, keep)
    want[nb].zero_()
    err = (got.double() - want.double()).abs().max().item()
    require(err == 0.0, f"cow_write_delta: kernel equals its plain version (max |diff| {err})")
    copy_rows = int(((src != dst) & (dst != nb)).sum())
    empty_rows = int((src == nb).sum() - (dst == nb).sum())
    scratch_k, scratch_p = data.clone(), data.clone()

    def plain():
        cow_write_delta_ref(scratch_p, src, dst, pos, values, keep)
        scratch_p[-1].zero_()

    ms = device_ms(lambda: cow_write_delta(scratch_k, src, dst, pos, values, keep))
    plain_ms = device_ms(plain)
    call_ms = time_ms(lambda: cow_write_delta(scratch_k, src, dst, pos, values, keep))
    moved_call = int(write_bytes(data, src, dst, pos, keep))
    dirty = data.clone()
    dirty[nb] = 1.0
    require(not cow_write_delta(dirty, src, dst, pos, values, keep)[nb].any()
            and torch.equal(dirty[:nb], got[:nb]),
            "cow_write_delta zeroes a dump row that held data on entry, in its one launch")
    per_call = traced_per_call(lambda: cow_write_delta(scratch_k, src, dst, pos, values, keep), 10)
    require_one_kernel_a_call(per_call, "cow_write_delta_kernel", "cow_write_delta")
    print(f"kernel cow_write_delta: exact on an append of {n} rows ({copy_rows} copy rows, "
          f"{empty_rows} of them reading nothing); {ms:.4f} ms on the device "
          f"({EARLIER_MS['cow_write_delta']} before the redesign), {call_ms:.4f} ms per call "
          f"(plain {plain_ms:.4f} ms); {moved_call} bytes; per call, traced: {json.dumps(per_call)}",
          flush=True)
    return {
        "name": "cow_write_delta", "route": "cuda", "source": "src/repro_torch/csrc/cow_write.cu",
        "replaces": "src/repro/kernels/cow_write/kernel.py:76",
        "launches": launches["cow_write_delta"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": moved_call / rate * 1e3, "bound_by": "bytes", "library_ms": None,
        "call_ms": call_ms,
    }


def mean_run(tables: torch.Tensor) -> float:
    """Mean length of the runs of one block id down the particle axis of
    ``[N, mb]`` tables."""
    heads = tables.shape[1] + int((tables[1:] != tables[:-1]).sum())
    return tables.numel() / heads


def flash_rounding_bound(qt, kt, vt, window):
    """The plain version in f32 on bf16 attention inputs ([B, H, S, d]
    views), and how far the tensor-core kernel's output may lie from it
    per element: P and the output are each rounded to bf16 (a relative
    2^-8 at most), so by 2^-8 (|out| + sum_j p_j |v_j|), to first order."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    q32, k32, v32 = qt.float(), kt.float(), vt.float()
    want = flash_attention_ref(q32, k32, v32, window=window)
    return want, 2.0**-8 * (want.abs() + flash_attention_ref(q32, k32, v32.abs(), window=window))


def planted_faults(qt, kt, vt, window) -> dict:
    """The bf16 outputs of two faults a tiled kernel can make, from f32
    attention under a changed mask: the 64-key tile before each row's
    diagonal tile dropped, and the causal edge (or, with a window, the
    window's edge) one key off."""
    b, h, s, d = qt.shape
    kvh = kt.shape[1]
    i = torch.arange(s, device=qt.device)
    causal = i[:, None] >= i[None, :]
    seen = causal & (i[:, None] - i[None, :] < window) if window else causal
    masks = {
        "tile_dropped": seen & (i[None, :] // 64 != i[:, None] // 64 - 1),
        "edge_off_by_one": (causal & (i[:, None] - i[None, :] < window + 1)) if window
        else i[None, :] <= i[:, None] + 1,
    }
    qg = qt.float().reshape(b, kvh, h // kvh, s, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, kt.float()) / math.sqrt(d)
    out = {}
    for name, mask in masks.items():
        p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
        o = torch.einsum("bkgqs,bksd->bkgqd", p, vt.float()).reshape(b, h, s, d)
        out[name] = o.to(qt.dtype).transpose(1, 2)
        del p, o
    return out


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention over s positions
    computes."""
    i = np.arange(s)
    return int(np.minimum(i + 1, window if window > 0 else s).sum())


def registry_inputs(dev):
    """Phase 11's generator and its draws: flash_attention's (name, (q, k,
    v), window) cases, then ssd_scan's (x, dt, a, B, C) at SSD_SHAPE."""
    from repro_torch import random as rnd

    gen = rnd.generator(SEED + 11, dev)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash_in = [(name, (randn(b, s, h, d, dtype=bf16), randn(b, s, kvh, d, dtype=bf16),
                        randn(b, s, kvh, d, dtype=bf16)), w) for name, b, s, h, kvh, d, w in FLASH_CASES]
    sb, ss, sh, sp, sn, _ = SSD_SHAPE
    ssd_in = (randn(sb, ss, sh, sp), torch.nn.functional.softplus(randn(sb, ss, sh)),
              -torch.exp(0.3 * randn(sh)), randn(sb, ss, sn), randn(sb, ss, sn))
    return gen, flash_in, ssd_in


def traced_per_call(fn, calls: int) -> dict:
    """Each device kernel's (µs, records) per call over ``calls`` calls of
    ``fn`` under torch.profiler (empty when CUPTI delivers no records)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {k[:72]: {"us": us / calls, "records": count / calls}
            for k, (us, count) in kernel_events(prof).items()}


def registry_phase(dev, rate, logw):
    """Phase 11: resample, flash_attention and ssd_scan through the
    registry at full width, each against its plain version on the card.
    Returns their rows."""
    from repro_torch import random as rnd
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.clone_chain import fixed_order_cumsum
    from repro_torch.kernels.clone_chain.ref import comb_positions
    from repro_torch.kernels.resample import (
        PLANTED, planted_cdfs, resample_systematic_kernel, resample_systematic_ref,
    )

    gen, flash_in, ssd_in = registry_inputs(dev)
    n = logw.shape[0]
    floor_buf = torch.zeros(1, dtype=torch.int32, device=dev)  # the launch floor's 4 bytes
    sq = SSD_SHAPE[-1]

    # -- the path: each op once through the registry --------------------------
    dispatch.reset_launch_counts()
    resample_systematic_kernel(gen, logw)
    flash = dispatch.get_op("flash_attention")
    for _, qkv, w in flash_in:
        flash(*qkv, window=w)
    dispatch.get_op("ssd_scan")(*ssd_in, chunk=sq)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"registry launches: {json.dumps(launches)}", flush=True)
    for op in ("resample", "flash_attention", "ssd_scan"):
        require(launches[op] > 0, f"kernel {op} launched through the registry ({launches[op]})")

    rows = []
    # resample: the comb on phase 2's final weights, and on the planted
    # CDFs at the comb's edges.
    comb = dispatch.get_op("resample")
    w = torch.softmax(logw, 0)
    cum = fixed_order_cumsum(w)
    cum = cum / cum[-1]
    u = rnd.uniform(gen, (1,))
    got, want = comb(cum, u), resample_systematic_ref(cum, u)
    require(torch.equal(got, want), "resample: kernel equals its plain version")
    sorted_ok = bool((got[1:] >= got[:-1]).all()) and int(got.min()) >= 0 and int(got.max()) < n
    require(sorted_ok, "resample: ancestors sorted and in range")
    for case, (pc, pu) in planted_cdfs(n, seed=SEED).items():
        pc, pu = pc.to(dev), pu.to(dev)
        before = comb.launches
        require(torch.equal(comb(pc, pu), resample_systematic_ref(pc, pu)) and comb.launches == before + 1,
                f"resample on the planted CDF {case}: kernel equals its plain version, in one launch")
    # The design's premise: a tile's ancestors lie near its own indices, in
    # a range that fits the stage.
    tiles = comb_tiles(cum, u)
    traced = traced_per_call(lambda: comb(cum, u), 10)
    require_one_kernel_a_call(traced, "resample_kernel", "resample")
    positions = comb_positions(u.reshape(()), n)
    bytes_ms = (8 * n + 4) / rate * 1e3
    ops_ms = n * (math.ceil(math.log2(n)) + 2) / F32_RATE * 1e3
    floor_ms = device_ms(lambda: floor_buf.zero_())
    row = {
        "name": "resample", "route": "cuda", "source": "src/repro_torch/csrc/resample.cu",
        "replaces": "src/repro/kernels/resample/kernel.py:44", "launches": launches["resample"],
        "max_abs_err": 0.0, "ms": device_ms(lambda: comb(cum, u)),
        "plain_ms": device_ms(lambda: resample_systematic_ref(cum, u)),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": device_ms(lambda: torch.searchsorted(cum, positions, side="left")),
        "call_ms": time_ms(lambda: comb(cum, u)), "launch_floor_ms": floor_ms,
    }
    rows.append(row)
    print(f"kernel resample: exact at N={n} ({int(torch.unique(got).numel())} distinct ancestors) and "
          f"on the planted CDFs {list(PLANTED)}, one launch each; tiles of {RESAMPLE_TILE} outputs "
          f"{json.dumps(tiles)}; {row['ms']:.5f} ms on the device "
          f"({EARLIER_MS['resample']} before the redesign), launch floor {floor_ms:.5f} ms (a 4-byte "
          f"zero_), plain {row['plain_ms']:.4f}, searchsorted {row['library_ms']:.4f}, bound "
          f"{row['bound_ms']:.5f}; traced per call {json.dumps(traced)}", flush=True)

    # flash_attention: each shape against the plain version: atol 2e-2,
    # and every element within FLASH_BOUND_LIMIT times its rounding bound
    # of the plain version in f32 (flash_rounding_bound), a check that
    # each planted fault must fail.
    shapes = []
    for name, qkv, w in flash_in:
        case = {"case": name, **flash_case(rate, (qkv, {"window": w}), f"flash_attention {name}",
                                           rtol=0.0, faults=True)}
        shapes.append(case)
        print(f"kernel flash_attention {name}: max |kernel - plain| {case['max_abs_err']!r}, rounding ratio "
              f"{case['rounding_ratio']!r} (planted faults {json.dumps(case['fault_ratios'])}); "
              f"{case['ms']:.4f} ms ({case['tflops']:.2f} TFLOP/s), plain {case['plain_ms']:.4f} ms, SDPA "
              f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms ({case['bound_by']}; "
              f"{case['flops']} flops, {case['bytes']} bytes)", flush=True)
    head = shapes[1]  # starcoder2-3b at S = 4,096: the largest, with a library call
    rows.append({
        "name": "flash_attention", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:94",
        "launches": launches["flash_attention"], "max_abs_err": max(c["max_abs_err"] for c in shapes),
        **{key: head[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "headline_shape": head["case"], "shapes": shapes,
    })
    torch.cuda.empty_cache()

    # ssd_scan at mamba2-130m's widths (f32, rtol/atol 2e-4).
    ssd = dispatch.get_op("ssd_scan")
    case = ssd_case(rate, (ssd_in, {"chunk": sq}), "ssd_scan")
    row = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:92", "launches": launches["ssd_scan"],
        **{key: case[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    rows.append(row)
    y, hf = ssd(*ssd_in, chunk=sq)
    y2, hf2 = ssd(*ssd_in, chunk=sq)
    require(torch.equal(y, y2) and torch.equal(hf, hf2), "ssd_scan: a repeat call is bit-equal")
    # Its two launches apart, traced (the chunk-parallel kernel, then the pass).
    per_launch = traced_per_call(lambda: ssd(*ssd_in, chunk=sq), 5)
    print(f"kernel ssd_scan: max |kernel - plain| {row['max_abs_err']!r} (y up to {case['largest_y']:.2f}), "
          f"a repeat call bit-equal; {row['ms']:.4f} ms on the device ({EARLIER_MS['ssd_scan']} "
          f"before the redesign), plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}; {case['flops']} flops, {case['bytes']} bytes); per launch, traced: "
          f"{json.dumps(per_launch)}", flush=True)
    return rows


# Phase 14: the paper's five programs (Section 4) at the paper's N and T
# (PCFG's T cut, PROGRAM_T).
# The small card-against-CPU runs' sizes, and the ops each program's path
# must launch.
PROGRAMS_SMALL = (64, 16)
# T where a program runs shorter than the paper's PAPER_T: PCFG's lazy
# runs took ~500 s of the script at the paper's 3,262 and 310-480 s at
# 2,000, where a run on a slow host reached 1,267 s of the script's
# 1,200-s limit; its host-bound bookkeeping grows with T.
PROGRAM_T = {"pcfg": 1000}
# Stacks in the masked write_at check at depth MAX_DEPTH - 1.
STACK_CHECK_ROWS = 1024
PROGRAM_OPS = {
    "rbpf": ("cow_write", "clone_chain"),
    "pcfg": ("cow_write", "clone_chain", "refcount_update"),
    "vbd": ("cow_write", "refcount_update", "cow_gather"),
    "mot": ("cow_write", "clone_chain"),
    "crbd": ("cow_write", "clone_chain"),
}


class Recorder:
    """A CPU generator that keeps what it draws, so that a ``Replay`` can
    hand the same draws to a run on the card."""

    def __init__(self, seed: int):
        from repro_torch import random as rnd

        self._rnd, self._gen = rnd, rnd.generator(seed, "cpu")
        self.device = torch.device("cpu")
        self.draws = []

    def _keep(self, kind, x):
        self.draws.append((kind, x.numpy().copy()))
        return x

    def uniform(self, shape):
        return self._keep("uniform", self._rnd.uniform(self._gen, shape))

    def normal(self, shape):
        return self._keep("normal", self._rnd.normal(self._gen, shape))

    def poisson(self, rate, shape):
        return self._keep("poisson", self._rnd.poisson(self._gen, rate, shape))


def with_ancestry(ssm, t_steps: int, tree_map):
    """``ssm`` with each resampling's ancestors kept in its state
    (``(state, [T, N] int32, count)``); the draws are unchanged."""
    clone = ssm.clone_state or (lambda s, a: tree_map(lambda x: x[a.long()], s))

    def init(gen, n, params):
        s = ssm.init(gen, n, params)
        return s, torch.zeros((t_steps, n), dtype=torch.int32, device=gen.device), 0

    def step(gen, state, t, y, params):
        s, logw, record = ssm.step(gen, state[0], t, y, params)
        return (s, *state[1:]), logw, record

    def clone_state(state, anc):
        s, hist, k = state
        hist = hist.clone()
        hist[k] = anc
        return clone(s, anc), hist, k + 1

    look, pin = ssm.lookahead, ssm.set_reference
    return ssm._replace(
        init=init, step=step, clone_state=clone_state,
        lookahead=None if look is None else (lambda st, t, y, p: look(st[0], t, y, p)),
        set_reference=None if pin is None else (lambda st, r: (pin(st[0], r), *st[1:])),
    )


def programs_phase(dev, rows) -> None:
    """Phase 14 (module docstring): each program at its PAPER_N and PAPER_T
    (PCFG at PROGRAM_T's)
    in EAGER, LAZY and LAZY_SR, its kernels counted from 0, its results
    checked; the small card-against-CPU runs; PCFG's masked ``write_at``,
    stack clone and VBD's ``materialize`` against their plain versions on
    the path's own inputs.  Prints ``{"programs": ...}`` and adds
    ``programs_launches`` to the kernel rows."""
    from repro_torch import random as rnd
    from repro_torch.core import store as store_lib
    from repro_torch.core.config import ALL_MODES, CopyMode
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_gather import cow_gather, cow_gather_ref
    from repro_torch.kernels.cow_write import cow_write, cow_write_ref
    from repro_torch.kernels.refcount_update import refcount_delta, refcount_delta_ref
    from repro_torch.smc import FilterConfig, ParticleFilter, ParticleGibbs
    from repro_torch.smc.executor import tree_map
    from repro_torch.smc.programs import PROBLEMS, pcfg, vbd

    def params_on(mod, where):
        return mod.default_params(where) if hasattr(mod, "default_params") else None

    def run(mod, mode, n, t, gen, obs, where, ssm=None):
        ssm = ssm or (mod.build(mode) if mod is pcfg else mod.build())[0]
        cfg = FilterConfig(n_particles=n, n_steps=t, mode=mode,
                           max_retries=6 if mod.METHOD == "alive" else 0)
        if mod.METHOD == "pg":
            pg = ParticleGibbs(ssm, cfg, device=where)
            return pg.store_cfg, pg.run(gen, params_on(mod, where), obs, n_iters=vbd.PG_ITERS)
        pf = ParticleFilter(ssm, cfg, device=where)
        return pf.store_cfg, pf.run(gen, params_on(mod, where), obs)

    def logz(res):
        return res.log_evidences if hasattr(res, "log_evidences") else res.log_evidence

    def peak(res):
        return int(res.peak_blocks if hasattr(res, "log_evidences") else res.store.peak_blocks)

    # The inputs of the last generation's stack writes (MAX_EXPAND x 2) and
    # the last stack clone of PCFG's LAZY run, and of the last materialize
    # of VBD's LAZY run, kept for the kernel checks (while `keep` names the
    # program: from the step of each sweep's last generation but one).
    kept, keep = {"cow_write": deque(maxlen=2 * pcfg.MAX_EXPAND)}, {"on": None}
    store_write, store_refcount, store_gather = (
        store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather)

    def keep_write(data, src, dst, pos, values):
        if keep["on"] == "pcfg" and data.dim() == 2:  # the stack's pool: [blocks + 1, 8] cells
            kept["cow_write"].append((data.clone(), src.clone(), dst.clone(), pos.clone(), values.clone()))
        return store_write(data, src, dst, pos, values)

    def keep_refcount(refcount, frozen, new_tables, old_tables, *, do_freeze):
        if keep["on"] == "pcfg":
            kept["refcount_update"] = (new_tables.clone(), old_tables.clone(), refcount.shape[0])
        return store_refcount(refcount, frozen, new_tables, old_tables, do_freeze=do_freeze)

    def keep_gather(data, table, out=None):
        got = store_gather(data, table, out)
        if keep["on"] == "vbd":
            kept["cow_gather"] = (data.clone(), table.clone(), got.clone())
        return got

    report, totals = {}, {}
    for name, mod in PROBLEMS.items():
        n, t = mod.PAPER_N, PROGRAM_T.get(name, mod.PAPER_T)
        iters = vbd.PG_ITERS if mod.METHOD == "pg" else 1
        obs = mod.gen_data(rnd.generator(SEED, dev), t)
        results, walls, gen_ms = {}, {}, []
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        for mode in ALL_MODES:
            ssm = (mod.build(mode) if mod is pcfg else mod.build())[0]
            step = ssm.step
            if mode is CopyMode.LAZY_SR:
                # One timestamp at each generation's first step (the alive
                # loop steps again within a generation), the card drained
                # first: their gaps are the walls per generation.
                stamps, seen = [], []

                def timed_step(gen, state, t_, y, params, step=step, stamps=stamps, seen=seen):
                    if not seen or seen[-1] != t_:
                        torch.cuda.synchronize()
                        stamps.append(time.perf_counter())
                        seen.append(t_)
                    return step(gen, state, t_, y, params)

                ssm = ssm._replace(step=timed_step)
                before = dispatch.launch_counts()
            elif mode is CopyMode.LAZY:

                def keeping_step(gen, state, t_, y, params, step=step, name=name, t=t):
                    keep["on"] = name if t_ >= t - 2 else None
                    return step(gen, state, t_, y, params)

                ssm = ssm._replace(step=keeping_step)
            (store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather) = (
                keep_write, keep_refcount, keep_gather)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cfg, res = run(mod, mode, n, t, rnd.generator(SEED, dev), obs, dev, ssm=ssm)
                torch.cuda.synchronize()
                walls[mode] = time.perf_counter() - t0
            finally:
                (store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather) = (
                    store_write, store_refcount, store_gather)
                keep["on"] = None
            if mode is CopyMode.LAZY_SR:
                sr_launches = {k: v - before[k] for k, v in dispatch.launch_counts().items()}
                gen_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:], strict=False)]
            results[mode] = (cfg, res)
            print(f"programs: {name} mode={mode.value} N={n} T={t} wall_s={walls[mode]:.3f} "
                  f"log_evidence={logz(res).tolist()!r} peak_blocks={peak(res)} "
                  f"oom={bool(res.oom)}", flush=True)
        launches = dispatch.launch_counts()
        for op, count in launches.items():
            totals[op] = totals.get(op, 0) + count
        for op in PROGRAM_OPS[name]:
            require(launches[op] > 0, f"{name}: kernel {op} launched on the program's path ({launches[op]})")

        # -- checks: bit-identical across modes, no oom, lazy below dense --
        bits = {m: logz(r).view(torch.int32).tolist() for m, (_, r) in results.items()}
        require(bits[CopyMode.EAGER] == bits[CopyMode.LAZY] == bits[CopyMode.LAZY_SR],
                f"{name}: log_evidence bit-identical across modes ({bits})")
        for mode, (_, res) in results.items():
            require(not bool(res.oom), f"{name} {mode.value}: oom is False")
        dense_blocks = n * -(-t // 4)
        peaks = {m.value: peak(r) for m, (_, r) in results.items()}
        entry = {"N": n, "T": t, "paper_T": mod.PAPER_T, "method": mod.METHOD, "iterations": iters,
                 "wall_s": {m.value: w for m, w in walls.items()},
                 "median_wall_ms_per_generation": float(np.median(gen_ms)),
                 "generations_timed": len(gen_ms),
                 "launches_per_generation": {op: sr_launches[op] / (t * iters) for op in FILTER_OPS},
                 "peak_blocks": peaks, "dense_blocks": dense_blocks,
                 "log_evidence": logz(results[CopyMode.LAZY_SR][1]).tolist()}
        if name != "pcfg":
            require(peaks["lazy_sr"] < dense_blocks,
                    f"{name}: LAZY_SR peak {peaks['lazy_sr']} below the dense {dense_blocks}")
        if iters > 1:
            ref = results[CopyMode.EAGER][1].reference
            require(all(torch.equal(r.reference, ref) for _, r in results.values()),
                    f"{name}: the retained reference equal across modes")
        else:
            eager = results[CopyMode.EAGER][1]
            sr_cfg, sr = results[CopyMode.LAZY_SR]
            trajs = store_lib.materialize_batch(sr_cfg, sr.store, torch.arange(n, device=dev))
            require(torch.equal(trajs[:, :t], eager.store.dense[:, :t]),
                    f"{name}: LAZY_SR materialize_batch of all {n} equals EAGER's dense trajectories")
            del trajs
        if name == "pcfg":
            scfg = pcfg._stack_cfg(n, CopyMode.LAZY_SR)
            stack = results[CopyMode.LAZY_SR][1].state.stack
            bound = n * scfg.max_blocks
            entry["stack"] = {"used_blocks": int(store_lib.used_blocks(scfg, stack)),
                              "peak_blocks": int(stack.peak_blocks), "bound": bound,
                              "oom": bool(stack.pool.oom.any())}
            require(entry["stack"]["peak_blocks"] <= bound and not entry["stack"]["oom"],
                    f"pcfg: the stack store stays within N x max_blocks ({entry['stack']})")
            print(f"programs: pcfg stack store {json.dumps(entry['stack'])}; trajectory store "
                  f"peak {peaks['lazy_sr']} of {dense_blocks} dense", flush=True)
        report[name] = entry
        del results, obs
        torch.cuda.empty_cache()

        # -- the card against the CPU path, on the same draws ---------------
        small_n, small_t = PROGRAMS_SMALL
        data = mod.gen_data(rnd.generator(SEED + 1, "cpu"), small_t)
        ssm = (mod.build(CopyMode.LAZY_SR) if mod is pcfg else mod.build())[0]
        # The alive loop's redraws go through clone_state too: CRBD's
        # genealogy is held by its tables alone.
        traced = mod.METHOD != "alive"
        if traced:
            ssm = with_ancestry(ssm, small_t, tree_map)
        recorder = Recorder(SEED + 2)
        _, cpu = run(mod, CopyMode.LAZY_SR, small_n, small_t, recorder, data, "cpu", ssm=ssm)
        replay = rnd.Replay(recorder.draws, dev)
        _, card = run(mod, CopyMode.LAZY_SR, small_n, small_t, replay,
                      tree_map(lambda x: x.to(dev), data), dev, ssm=ssm)
        require(replay.remaining == 0, f"{name} small: the card consumed the CPU run's draws")
        require(torch.allclose(logz(card).cpu(), logz(cpu), rtol=1e-5, atol=0),
                f"{name} small: log_evidence on the card {logz(card).tolist()} and the CPU "
                f"{logz(cpu).tolist()} within rtol 1e-5")
        if iters > 1:
            same = [(card.used_blocks_trace, cpu.used_blocks_trace), (card.peak_blocks, cpu.peak_blocks)]
        else:
            same = [(card.store.tables, cpu.store.tables), (card.resampled, cpu.resampled)]
            inner_card, inner_cpu = card.state, cpu.state
            if traced:
                same.append((card.state[1], cpu.state[1]))
                inner_card, inner_cpu = card.state[0], cpu.state[0]
            if name == "pcfg":
                same.append((inner_card.sp, inner_cpu.sp))
            elif name == "mot":
                same.append((inner_card[1], inner_cpu[1]))
            elif name == "crbd":
                same.append((inner_card, inner_cpu))
        for a, b in same:
            require(torch.equal(a.cpu(), b), f"{name} small: integer results equal on the card and the CPU")
        print(f"programs: {name} N={small_n} T={small_t} on the card agrees with the CPU path "
              f"(log_evidence {logz(card).tolist()!r} vs {logz(cpu).tolist()!r})", flush=True)

    # -- kernels against their plain versions on the path's own inputs ------
    writes = kept.pop("cow_write")
    routed = {"rows": 0, "masked": 0, "copies": 0}
    for data, src, dst, pos, values in writes:
        nb = data.shape[0] - 1
        got = cow_write(data.clone(), src, dst, pos, values)
        want = cow_write_ref(data.clone(), src, dst, pos, values)
        require(torch.equal(got[:nb], want[:nb]) and not got[nb].any(),
                "pcfg: cow_write equals its plain version on a stack write, the dump row zero")
        routed["rows"] += src.shape[0]
        routed["masked"] += int((dst == nb).sum())
        routed["copies"] += int(((src != dst) & (dst < nb)).sum())
    require(len(writes) == 2 * pcfg.MAX_EXPAND and routed["masked"] < routed["rows"],
            f"pcfg: the last generation's stack writes kept, some rows unmasked ({routed})")
    new, old, nb_rc = kept.pop("refcount_update")
    mb = new.shape[-1]
    got = refcount_delta(new.reshape(-1).contiguous(), old.reshape(-1).contiguous(), nb_rc, row=mb)
    want = refcount_delta_ref(new.reshape(-1).contiguous(), old.reshape(-1).contiguous(), nb_rc)
    require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
            "pcfg: refcount_update equals its plain version on the last stack clone")
    gdata, table, out = kept.pop("cow_gather")
    require(torch.equal(out, cow_gather_ref(gdata, table)),
            "vbd: cow_gather equals its plain version on particle Gibbs' last materialize")
    print(f"programs: cow_write on PCFG's last {len(writes)} stack writes ({json.dumps(routed)}), "
          f"refcount_update on its last stack clone ({new.shape[0]} x {mb} "
          f"tables, {nb_rc} blocks), cow_gather on VBD's last materialize ({table.shape[0]} "
          "blocks) equal their plain versions", flush=True)

    # -- a masked write_at at MAX_DEPTH - 1 on shared stacks, card and CPU --
    scfg = pcfg._stack_cfg(STACK_CHECK_ROWS, CopyMode.LAZY)

    def shared_stacks(where):
        """Every cell written, then each stack cloned to two rows (LAZY
        freezes the shared blocks), and the last write's arguments: even
        rows at depth MAX_DEPTH - 1, every third row masked off."""
        gen = rnd.generator(SEED + 3, "cpu")  # one stream of values for both
        stack = store_lib.create(scfg, where)
        ids = torch.arange(scfg.n, device=where)
        for depth in range(pcfg.MAX_DEPTH):
            stack = store_lib.write_at(scfg, stack, torch.full((scfg.n,), depth, device=where),
                                       rnd.uniform(gen, (scfg.n,)).to(where))
        stack = store_lib.clone(scfg, stack, (ids // 2).to(torch.int32))
        positions = torch.where(ids % 2 == 0, pcfg.MAX_DEPTH - 1, ids % pcfg.MAX_DEPTH).to(torch.int32)
        return stack, positions, rnd.uniform(gen, (scfg.n,)).to(where), ids % 3 != 0

    cpu_args = shared_stacks("cpu")
    cpu = store_lib.write_at(scfg, *cpu_args[:3], mask=cpu_args[3])
    card_args = shared_stacks(dev)
    dispatch.reset_launch_counts()
    card = store_lib.write_at(scfg, *card_args[:3], mask=card_args[3])
    require(dispatch.launch_counts()["cow_write"] == 1, "the stack write_at launched cow_write once")
    require(torch.equal(card.pool.data[:-1].cpu(), cpu.pool.data[:-1]) and not card.pool.data[-1].any()
            and torch.equal(card.tables.cpu(), cpu.tables)
            and torch.equal(card.pool.refcount.cpu(), cpu.pool.refcount),
            "a masked write_at at MAX_DEPTH - 1 on shared LAZY stacks: the card equals the CPU "
            "path, the dump row zero")
    print(f"programs: a masked write_at at depth {pcfg.MAX_DEPTH - 1} on {scfg.n} shared LAZY "
          "stacks equals the CPU path; the dump row stays zero", flush=True)

    for row in rows:
        if row["name"] in totals and row["name"] in FILTER_OPS:
            row["programs_launches"] = totals[row["name"]]
    print(json.dumps({"programs": report}), flush=True)


# Phase 15: the moe and audio families at full width.  deepseek-moe-16b
# (28 layers, layer 0 dense, 64 routed experts top-6 + 2 shared, 16 heads
# over 16 KV heads of 128, vocab 102,400, untied) and musicgen-large (48
# layers, 32 heads over 32 of 64, non-gated GELU MLP, vocab 2,048), random
# weights from the seed, each layer matrix cast to bf16 as it is drawn.
MOE_ARCH, AUDIO_ARCH = "deepseek_moe_16b", "musicgen_large"
FAMILY_SERVE_TOKENS = 16
MOE_SMC_STEPS = 32
MOE_PREEMPT_AT = 10
MOE_CHECKPOINT_AT = 16
# The tick whose paged-attention calls and routing are kept.
MOE_ATTN_AT = 24
# As drawn, deepseek's untied unembedding (std 1/sqrt(102,400)) gives
# logits of std ~0.14 over the normed state: the proposal is nearly flat,
# the weights barely move and the population seldom resamples.  Scaled by
# 8 the logits have std ~1.1.  The phase prints the first step's proposal
# both ways.
MOE_UNEMBED_SCALE = 8.0


class AttentionTap:
    """Stands in for the engine's ``paged_attention``: while ``armed``, keeps
    the first and the latest call (inputs and output) of the tick."""

    def __init__(self, attention):
        self.attention, self.armed, self.calls = attention, False, []

    def __call__(self, q, k_pool, v_pool, tables, lengths, **kw):
        out = self.attention(q, k_pool, v_pool, tables, lengths, **kw)
        if self.armed:
            kv = torch.stack([k_pool, v_pool], 1).clone()  # [rows, 2, bs, KVH, hd]
            self.calls.append((q.clone(), kv, tables.clone(), lengths.clone(),
                               {k: v.clone() for k, v in kw.items()}, out.clone()))
            del self.calls[1:-1]
        return out


def attention_row(rate, calls, n_heads, what) -> dict:
    """The kept calls against the plain version (bf16, atol 1e-2; a repeat
    call bit-equal), then the first call's device time, the plain
    version's and its bound."""
    import types

    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref

    require(len(calls) == 2, f"{what}: the tick's first and last paged-attention calls kept")
    errs = []
    for q, kv, tables, lengths, kw, out in calls:
        args = (q, kv[:, 0], kv[:, 1], tables, lengths)
        require(torch.equal(paged_attention(*args, **kw), out), f"{what}: a repeat call is bit-equal")
        errs.append((out.float() - paged_attention_ref(*args, **kw).float()).abs().max().item())
    err = max(errs)
    require(err <= 1e-2, f"{what}: bf16 kernel within atol 1e-2 of its plain version ({err})")
    q, kv, tables, lengths, kw, _ = calls[0]
    args = (q, kv[:, 0], kv[:, 1], tables, lengths)
    pool = types.SimpleNamespace(data=kv[:, None], parent=kw.get("parent"), dirty=kw.get("dirty"))
    moved = paged_bytes(types.SimpleNamespace(pool=pool, tables=tables, lengths=lengths), bool(kw), n_heads)
    bytes_ms = moved / rate * 1e3
    ops_ms = 4 * n_heads * q.shape[-1] * int(lengths.sum()) / BF16_RATE * 1e3
    return {"max_abs_err": err, "ms": device_ms(lambda: paged_attention(*args, **kw)),
            "plain_ms": device_ms(lambda: paged_attention_ref(*args, **kw)),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "rows": q.shape[0], "heads": q.shape[1], "kv_heads": kv.shape[3],
            "head_dim": q.shape[-1], "slots_read": int(lengths.sum())}


def serve_both(dev, lm, weights, prompts, label):
    """Prefill ``prompts`` into 16 rows' engine, fork each to 4 rows,
    decode FAMILY_SERVE_TOKENS Gumbel-sampled tokens, once with whole-page
    and once with delta COW: logits and tokens bit-identical.  Returns the
    prefill's logits, the whole-page run's last step's paged-attention
    calls, the runs' launches and their times."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.engine import ServeEngine

    cfg = lm.cfg
    plen = prompts.shape[1]
    base = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS,
        max_blocks_per_seq=-(-(plen + FAMILY_SERVE_TOKENS + 16) // SERVE_BLOCK), dtype=cfg.dtype,
    )
    base = kvc.KVCacheConfig(**{**vars(base), "num_blocks": base.pool_blocks_cap})
    groups = SERVE_SLOTS // prompts.shape[0]
    tap = AttentionTap(engine_lib.paged_attention)
    runs = {}
    dispatch.reset_launch_counts()
    for delta_cow in (False, True):
        engine = ServeEngine(lm, weights, kvc.KVCacheConfig(**{**vars(base), "delta_cow": delta_cow}),
                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = engine.prefill(prompts, torch.arange(prompts.shape[0], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        anc = torch.arange(SERVE_SLOTS, device=dev) // groups
        tok = gumbel_sample(logits, gen)[anc][:, None]
        engine.fork(anc)
        out = {"logits": [logits], "tokens": []}
        engine_lib.paged_attention = tap
        try:
            t = time.perf_counter()
            for step in range(FAMILY_SERVE_TOKENS):
                tap.armed = not delta_cow and step == FAMILY_SERVE_TOKENS - 1
                logits = engine.decode(tok)
                tok = gumbel_sample(logits, gen)[:, None]
                out["logits"].append(logits)
                out["tokens"].append(tok)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t
        finally:
            engine_lib.paged_attention = tap.attention
            tap.armed = False
        require(not engine.oom, f"{label} delta_cow={delta_cow}: oom is False")
        for lg in out["logits"]:
            require(bool(torch.isfinite(lg).all()) and lg.shape[-1] == cfg.padded_vocab,
                    f"{label}: finite logits over the padded vocabulary")
        print(f"{label} serve delta_cow={delta_cow}: prefill {prompts.shape[0]} x {plen} tokens "
              f"{prefill_s:.3f} s; {FAMILY_SERVE_TOKENS} tokens x {SERVE_SLOTS} rows in {decode_s:.3f} s "
              f"({decode_s / FAMILY_SERVE_TOKENS * 1e3:.2f} ms per token); live pages "
              f"{int(kvc.used_blocks(engine.cache))}; oom=False", flush=True)
        runs[delta_cow] = (engine, out, prefill_s, decode_s)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    for op in ("paged_attention", "paged_attention_delta"):
        require(launches[op] > 0, f"{label}: kernel {op} launched on the serving path ({launches[op]})")
    whole, delta = runs[False][1], runs[True][1]
    for key in ("logits", "tokens"):
        for a, b in zip(whole[key], delta[key], strict=True):
            require(torch.equal(a, b), f"{label}: delta COW on and off give bit-identical {key}")
    print(f"{label} serve: delta COW on and off bit-identical over {len(whole['logits'])} logit sets "
          f"and {len(whole['tokens'])} token steps; launches {json.dumps(launches)}", flush=True)
    summary = {"prefill_s": {str(k): v[2] for k, v in runs.items()},
               "decode_ms_per_token": {str(k): v[3] / FAMILY_SERVE_TOKENS * 1e3 for k, v in runs.items()}}
    return whole["logits"][0], tap.calls, launches, summary


def family_phase(dev, rate, rows) -> None:
    """Phase 15 (module docstring): deepseek-moe-16b served and decoding SMC
    populations through the scheduler, musicgen-large served, both at full
    width, the paged kernel against its plain version at G = 1 and head
    dims 128 and 64, the smoke configs on the card against the CPU, and the
    serve CLI for both.  Adds the launches and the new shapes' times to the
    kernel rows."""
    import pickle

    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving import engine as engine_lib
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.crosscheck import LOGIT_TOL, ROUTE_GAP, card_against_cpu
    from repro_torch.serving.engine import ServeEngine, draw_cast_params
    from repro_torch.serving.scheduler import DecodeRequest, Scheduler, SchedulerEventLog

    phase_t0 = time.perf_counter()
    report = {}
    cfg = get_config(MOE_ARCH)
    lm = LanguageModel(cfg)
    torch.cuda.synchronize()
    before_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    weights = draw_cast_params(lm, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    drawn_s = time.perf_counter() - t
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    held_gib = torch.cuda.memory_allocated() / 2**30
    n_params = sum(int(np.prod(s)) for s in lm.param_specs().values())
    print(f"moe: {cfg.name} drawn leaf by leaf and cast in {drawn_s:.1f} s: {n_params} parameters; "
          f"device memory before {before_gib:.2f} GiB, peak while drawing {peak_gib:.2f} GiB, "
          f"held after {held_gib:.2f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    require(peak_gib < 60, f"the drawing's peak {peak_gib:.2f} GiB stays near the cast tree plus one leaf")
    report["deepseek_weights"] = {"parameters": n_params, "draw_s": drawn_s, "peak_gib": peak_gib,
                                  "held_gib": held_gib}
    weights["unembed"].mul_(MOE_UNEMBED_SCALE)

    # -- 1. serve: 4 prompts of 500 tokens, 16 rows, whole-page and delta ----
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 30), device=dev)
    prefill, _, serve_launches, report["deepseek_serve"] = serve_both(dev, lm, weights, prompts, "moe")
    first = prefill[0]

    def proposal(logits):
        p = torch.softmax(logits, dim=-1)
        return {"top_prob": p.max().item(), "entropy_nats": -torch.xlogy(p, p).sum().item(),
                "logit_std": logits.std().item()}

    report["first_step_proposal"] = {"scaled": proposal(first),
                                     "as_drawn": proposal(first / MOE_UNEMBED_SCALE)}
    print(f"moe: the first step's proposal {json.dumps(report['first_step_proposal'])}", flush=True)

    # -- 2. SMC decoding through the scheduler ---------------------------------
    ccfg = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=SERVE_BLOCK, max_seqs=SMC_SLOTS,
        max_blocks_per_seq=-(-(SMC_PROMPT_LEN + MOE_SMC_STEPS + 16) // SERVE_BLOCK), dtype=cfg.dtype,
    )
    smc_prompts = torch.randint(0, cfg.vocab_size, (SMC_REQUESTS, SMC_PROMPT_LEN),
                                generator=torch.Generator(device=dev).manual_seed(SEED + 32), device=dev)
    rids = [f"m{i}" for i in range(SMC_REQUESTS)]

    def request(i):
        return DecodeRequest(
            rid=rids[i], prompt=smc_prompts[i], n_particles=SMC_PARTICLES, steps=MOE_SMC_STEPS,
            gen=torch.Generator(device=dev).manual_seed(SEED + 33 + i),
            target_temp=SMC_TARGET_TEMP, proposal_temp=SMC_PROPOSAL_TEMP, ess_threshold=SMC_ESS,
        )

    def schedule(reqs, delta_cow=False, **kw):
        sched = Scheduler(ServeEngine(lm, weights, kvc.KVCacheConfig(**{**vars(ccfg), "delta_cow": delta_cow}),
                                      device=dev), **kw)
        for r in reqs:
            sched.submit(r)
        return sched

    def same(got, want):
        return all(torch.equal(getattr(got, f), getattr(want, f))
                   for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"))

    log = SchedulerEventLog()
    sched = schedule([request(i) for i in range(SMC_REQUESTS)], event_log=log)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    walls = []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        more = sched.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if not more:
            break
    wall_s = time.perf_counter() - t0
    launches = dispatch.launch_counts()
    main, ticks = sched.results, sched.stats.ticks
    for op in SMC_OPS:
        require(launches[op] > 0, f"moe SMC: kernel {op} launched on the path ({launches[op]})")
    dense = SMC_REQUESTS * SMC_PARTICLES * -(-(SMC_PROMPT_LEN + MOE_SMC_STEPS) // SERVE_BLOCK)
    for rid in rids:
        res = main[rid]
        require(res.status == "ok" and not bool(res.oom), f"moe {rid}: ok, oom False")
        require(bool(res.resampled.any()), f"moe {rid}: resampled at least once ({res.ess_trace.tolist()})")
        require(tuple(res.tokens.shape) == (SMC_PARTICLES, MOE_SMC_STEPS)
                and bool(((res.tokens >= 0) & (res.tokens < cfg.padded_vocab)).all()),
                f"moe {rid}: tokens in the vocabulary")
        require(math.isfinite(float(res.log_evidence)) and bool(torch.isfinite(res.ess_trace).all()),
                f"moe {rid}: finite log-evidence and ESS")
    median_ms = sorted(walls)[len(walls) // 2] * 1e3
    print(f"moe smc main: {ticks} ticks in {wall_s:.2f} s; per tick median {median_ms:.2f} ms; resamples "
          f"{[int(main[r].resampled.sum()) for r in rids]}; peak {log.peak_blocks()} pages (dense "
          f"{dense}); launches {json.dumps(launches)}", flush=True)

    # -- the delta run, bit-identical; its tick MOE_ATTN_AT's paged attention
    # and routing, and the token store's last cow_write, clone_chain and
    # final cow_gather, kept ------------------------------------------------
    tap = AttentionTap(engine_lib.paged_attention)
    captured, route = {}, moe_lib.route

    def arm(s):
        tap.armed = s.tick == MOE_ATTN_AT

    def capture_route(router, tokens, c):
        r = route(router, tokens, c)
        if tap.armed:
            captured.setdefault("dropped", []).append(int((~r.keep).sum()))
            captured["pairs_per_layer"] = r.keep.numel()
            captured["cap"] = r.cap
        return r

    sched = schedule([request(i) for i in range(SMC_REQUESTS)], delta_cow=True, on_boundary=arm)
    dispatch.reset_launch_counts()
    engine_lib.paged_attention, moe_lib.route = tap, capture_route
    try:
        with token_store_calls(captured):
            res = sched.run()
    finally:
        engine_lib.paged_attention, moe_lib.route = tap.attention, route
        tap.armed = False
    torch.cuda.synchronize()
    delta_launches = dispatch.launch_counts()
    require(delta_launches["paged_attention_delta"] > 0,
            f"moe: kernel paged_attention_delta launched ({delta_launches['paged_attention_delta']})")
    for rid in rids:
        require(same(res[rid], main[rid]), f"moe {rid}: kv_delta_cow=True bit-identical")
    delta_calls = tap.calls
    dropped = captured.pop("dropped")
    report["routing_at_tick"] = {
        "tick": MOE_ATTN_AT, "layers": len(dropped), "pairs_per_layer": captured.pop("pairs_per_layer"),
        "capacity": captured.pop("cap"), "dropped_pairs": sum(dropped), "dropped_per_layer": dropped}
    print(f"moe smc: kv_delta_cow=True bit-identical; launches {json.dumps(delta_launches)}; "
          f"routing at tick {MOE_ATTN_AT} (the keep mask): {json.dumps(report['routing_at_tick'])}",
          flush=True)

    # -- checkpoint at tick MOE_CHECKPOINT_AT, restore on a fresh engine;
    # the restored run's tick MOE_ATTN_AT paged attention kept ---------------
    saved = {}

    class Kill(Exception):
        pass

    def checkpoint_at(s):
        if s.tick == MOE_CHECKPOINT_AT and not saved:
            saved["state"] = pickle.loads(pickle.dumps(s.checkpoint()))
            raise Kill

    sched = schedule([request(i) for i in range(SMC_REQUESTS)], on_boundary=checkpoint_at)
    try:
        sched.run()
    except Kill:
        pass
    require("state" in saved, f"moe: a checkpoint at tick {MOE_CHECKPOINT_AT}")
    del sched
    restored = Scheduler.restore(
        ServeEngine(lm, weights, ccfg, device=dev), saved.pop("state"), on_boundary=arm)
    tap.calls = []
    engine_lib.paged_attention = tap
    try:
        res = restored.run()
    finally:
        engine_lib.paged_attention = tap.attention
        tap.armed = False
    for rid in rids:
        require(same(res[rid], main[rid]), f"moe {rid}: restored from the checkpoint at tick "
                f"{MOE_CHECKPOINT_AT}, bit-exact")
    whole_calls = tap.calls
    del restored, res
    print(f"moe smc: checkpoint at tick {MOE_CHECKPOINT_AT}, restore on a fresh engine: bit-exact",
          flush=True)

    # -- coupling, run and reported: each request alone, and a preemption ------
    coupling = {}
    for i, rid in enumerate(rids):
        coupling[f"{rid}_alone_bit_exact"] = same(schedule([request(i)]).run()[rid], main[rid])

    def preempt_once(s):
        if s.tick == MOE_PREEMPT_AT and not s.stats.preemptions:
            s.preempt(rids[-1])

    sched = schedule([request(i) for i in range(SMC_REQUESTS)], on_boundary=preempt_once)
    res = sched.run()
    require(sched.stats.preemptions == 1, f"moe: one preemption at tick {MOE_PREEMPT_AT}")
    for rid in rids:
        coupling[f"{rid}_with_preemption_bit_exact"] = same(res[rid], main[rid])
    del sched, res
    report["coupling"] = coupling
    print(f"moe smc coupling (reported, not required: capacity couples a step's rows): "
          f"{json.dumps(coupling)}", flush=True)

    # -- 3. the path's kernels against their plain versions --------------------
    attention = {"paged_attention": attention_row(rate, whole_calls, cfg.n_heads, "moe paged_attention"),
                 "paged_attention_delta": attention_row(rate, delta_calls, cfg.n_heads,
                                                        "moe paged_attention_delta")}
    del whole_calls, delta_calls
    store_calls = check_token_store_calls(captured, "moe")
    print(f"moe smc: tick {MOE_ATTN_AT}'s paged attention (layers 0 and {cfg.n_layers - 1}) against the "
          f"plain version, limit 1e-2: {json.dumps(attention)}; {store_calls} equal their plain "
          f"versions", flush=True)
    report["deepseek_smc"] = {
        "requests": SMC_REQUESTS, "particles": SMC_PARTICLES, "rows": SMC_SLOTS,
        "prompt_len": SMC_PROMPT_LEN, "steps": MOE_SMC_STEPS, "ticks": ticks,
        "wall_ms_per_tick_median": median_ms, "wall_ms_per_tick_min": min(walls) * 1e3, "wall_s": wall_s,
        "launches_per_tick": {op: launches[op] / ticks for op in SMC_OPS},
        "launches": {**{op: launches[op] for op in SMC_OPS},
                     "paged_attention_delta": delta_launches["paged_attention_delta"]},
        "resamples": {rid: int(main[rid].resampled.sum()) for rid in rids},
        "peak_pages": log.peak_blocks(), "dense_pages": dense,
        "paged_attention_against_plain": attention}
    del weights, main, captured
    torch.cuda.empty_cache()

    # -- 5. the serve CLI at full width ----------------------------------------
    def cli(arch):
        dispatch.reset_launch_counts()
        toks = serve_cli.main(["--arch", arch, "--full"])
        torch.cuda.synchronize()
        count = dispatch.launch_counts()["paged_attention"]
        vocab = get_config(arch).padded_vocab
        require(count > 0, f"serve --arch {arch} --full went through paged_attention")
        require(toks.shape == (4, 33) and bool(((toks >= 0) & (toks < vocab)).all()),
                f"serve --arch {arch} --full returns 4 continuations of 33 tokens ({tuple(toks.shape)})")
        torch.cuda.empty_cache()
        return count

    report["cli_paged_attention_launches"] = {MOE_ARCH: cli(MOE_ARCH)}

    # -- musicgen-large: serve, the paged kernel at head dim 64, the CLI --------
    acfg = get_config(AUDIO_ARCH)
    alm = LanguageModel(acfg)
    t = time.perf_counter()
    aweights = draw_cast_params(alm, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    print(f"audio: {acfg.name} drawn and cast in {time.perf_counter() - t:.1f} s", flush=True)
    prompts = torch.randint(0, acfg.vocab_size, (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 34), device=dev)
    _, calls, audio_launches, report["musicgen_serve"] = serve_both(dev, alm, aweights, prompts, "audio")
    attention["paged_attention_musicgen"] = attention_row(rate, calls, acfg.n_heads,
                                                          "audio paged_attention")
    print(f"audio: the last decode step's paged attention (layers 0 and {acfg.n_layers - 1}) against the "
          f"plain version: {json.dumps(attention['paged_attention_musicgen'])}", flush=True)
    del calls, aweights
    torch.cuda.empty_cache()
    report["cli_paged_attention_launches"][AUDIO_ARCH] = cli(AUDIO_ARCH)

    # -- the smoke configs on the card against the CPU path ----------------------
    report["smoke_card_against_cpu"] = {}
    for arch in (MOE_ARCH, AUDIO_ARCH):
        readings, _ = card_against_cpu(dev, arch)
        report["smoke_card_against_cpu"][arch] = readings
    print(f"family smoke runs: card equals the CPU path (tables, refcounts, lengths; routing where "
          f"the top-k gap exceeds {ROUTE_GAP}); logits within {LOGIT_TOL} x the step's largest logit: "
          f"{json.dumps(report['smoke_card_against_cpu'])}", flush=True)

    counts = {"paged_attention": {"deepseek_serve": serve_launches["paged_attention"],
                                  "deepseek_smc": launches["paged_attention"],
                                  "musicgen_serve": audio_launches["paged_attention"]},
              "paged_attention_delta": {"deepseek_serve": serve_launches["paged_attention_delta"],
                                        "deepseek_smc": delta_launches["paged_attention_delta"],
                                        "musicgen_serve": audio_launches["paged_attention_delta"]},
              **{op: {"deepseek_smc": launches[op]} for op in ("clone_chain", "cow_write", "cow_gather")}}
    shapes = {"paged_attention": {"deepseek_smc_tick": attention["paged_attention"],
                                  "musicgen_serve_step": attention["paged_attention_musicgen"]},
              "paged_attention_delta": {"deepseek_smc_tick": attention["paged_attention_delta"]}}
    for row in rows:
        if row["name"] in counts:
            row["family_launches"] = counts[row["name"]]
        if row["name"] in shapes:
            row["family_shapes"] = shapes[row["name"]]
    report["phase_s"] = time.perf_counter() - phase_t0
    print(json.dumps({"families": report}), flush=True)


# Phase 16: the dense-cache families at full width.  Each model's
# (arch, layers kept (None: all), batch, prompt, greedy steps); prompt plus
# steps is the teacher-forced length of the forward the steps are held to.
# The SSM models' lengths are multiples of 64, as the card's SSD scan
# takes them (chunk 64).
DENSE_CELLS = (
    ("mamba2_130m", None, 4, 1984, 64),
    ("zamba2_7b", None, 4, 960, 64),
    ("gemma3_12b", None, 2, 2016, 32),
    ("llama32_vision_90b", 20, 2, 480, 32),  # 20 of 100 layers: ~43 GB in bf16
)
# mamba2-130m once more in float32 activations and weights: the same
# decode-against-forward reading without bf16 rounding, which tells the
# rounding's share of the bf16 gaps from a fault's.
F32_CONTROL = "mamba2_130m"
DENSE_OPS = ("flash_attention", "ssd_scan")
# Lengths whose chunk min(64, S) is no multiple of 16: the card's scan
# runs them over a dt = 0 tail.  And bf16 flash at the smoke head dims
# 16 and 32 (the CUDA-core kernel), at [B, S, H over KVH].
SHORT_SSM_PROMPTS = (1, 20, 40)
SMALL_HEAD_FLASH = (2, 512, 8, 2)


class KernelTap:
    """Stands in for a model module's name for a kernel wrapper: while
    ``armed``, keeps the first and the latest call's inputs (cloned).  The
    wrapper it calls counts the launches."""

    def __init__(self, fn):
        self.fn, self.armed, self.calls = fn, False, []

    def __call__(self, *args, **kw):
        if self.armed:
            self.calls.append(([a.clone() if torch.is_tensor(a) else a for a in args], dict(kw)))
            del self.calls[1:-1]
        return self.fn(*args, **kw)


def predicted_launches(cfg) -> dict:
    """Kernel launches of one prefill (or forward) pass: a flash launch per
    self-attention layer (hybrid: per shared-block invocation), an
    ssd_scan launch per SSM layer."""
    if cfg.family == "ssm":
        attn = 0
    elif cfg.family == "hybrid":
        attn = cfg.n_layers // cfg.attn_every
    else:
        attn = cfg.n_layers
    return {"flash_attention": attn, "ssd_scan": cfg.n_layers if cfg.uses_ssm else 0}


def flash_case(rate, call, what, rtol=2e-2, faults=False) -> dict:
    """A flash call against its plain version (bf16: within atol 2e-2 plus
    ``rtol`` of the plain value, and each element within FLASH_BOUND_LIMIT
    of its rounding bound; with ``faults``, a check that each planted fault
    must fail), then its time, the plain version's, SDPA's and the bound."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    (q, k, v), kw = call
    w = kw.get("window", 0)
    b, s, h, d = q.shape
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = flash_attention(q, k, v, window=w)
    want = flash_attention_ref(qt, kt, vt, window=w).transpose(1, 2).float()
    diff = (got.float() - want).abs()
    err, worst = diff.max().item(), (diff / (2e-2 + rtol * want.abs())).max().item()
    require(bool(torch.isfinite(got).all()) and got.shape == q.shape, f"{what}: finite output")
    # Phase 16 holds it at atol and rtol 2e-2, as the cuda tests do
    # (check_flash): the path's outputs reach |8|, where one bf16 step
    # (2^-5) passes an atol alone.  Phase 11's random inputs keep the atol
    # alone.
    require(worst <= 1.0, f"{what}: within atol 2e-2, rtol {rtol} of its plain version ({err}, {worst} of the limit)")
    del want, diff
    want32, bound = flash_rounding_bound(qt, kt, vt, w)

    def ratio_of(out):
        return ((out.transpose(1, 2).float() - want32).abs() / bound).max().item()

    ratio = ratio_of(got)
    require(ratio <= FLASH_BOUND_LIMIT, f"{what}: within {FLASH_BOUND_LIMIT} of its rounding bound ({ratio})")
    case = {"shape": [b, s, h, k.shape[2], d], "window": w, "max_abs_err": err, "tolerance_ratio": worst,
            "rounding_ratio": ratio}
    if faults:
        case["fault_ratios"] = {fault: ratio_of(out) for fault, out in planted_faults(qt, kt, vt, w).items()}
        require(min(case["fault_ratios"].values()) > FLASH_BOUND_LIMIT,
                f"{what}: the check rejects each planted fault {case['fault_ratios']}")
    del want32, bound, got
    moved = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * d * attention_pairs(s, w) * b * h
    bytes_ms, ops_ms = moved / rate * 1e3, flops / BF16_RATE * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if w == 0:
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    else:  # the causal-and-window mask, built outside the timed region
        i = torch.arange(s, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True))
        del mask
    case.update({
        "ms": device_ms(lambda: flash_attention(q, k, v, window=w)),
        "plain_ms": device_ms(lambda: flash_attention_ref(qt, kt, vt, window=w), reps=3, warmup=1),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "flops": flops, "bytes": moved,
    })
    case["tflops"] = flops / case["ms"] / 1e9
    return case


def ssd_case(rate, call, what) -> dict:
    """A captured ssd_scan call against its plain version (rtol/atol 2e-4),
    then its time, the plain version's and the bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref

    args, kw = call
    x, dt, a, bmat, cmat = args
    chunk = kw["chunk"]
    y, hf = ssd_scan(*args, chunk=chunk)
    yr, hr = ssd_scan_ref(*args, chunk=chunk)
    for got, want, part in ((y, yr, "y"), (hf, hr, "final state")):
        require(bool(torch.isfinite(got).all()), f"{what} {part}: finite")
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4, msg=f"{what} {part} against its plain version")
    err = max((y - yr).abs().max().item(), (hf - hr).abs().max().item())
    largest_y = yr.abs().max().item()
    del yr, hr
    b, s, h, p = x.shape
    n, q = bmat.shape[-1], min(chunk, s)
    flops = 2 * b * h * (s // q) * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
    moved = 4 * (sum(t.numel() for t in args) + y.numel() + hf.numel())
    bytes_ms, ops_ms = moved / rate * 1e3, flops / TF32_RATE * 1e3
    return {"shape": [b, s, h, p, n], "chunk": q, "max_abs_err": err, "largest_y": largest_y,
            "ms": device_ms(lambda: ssd_scan(*args, chunk=chunk)),
            "plain_ms": device_ms(lambda: ssd_scan_ref(*args, chunk=chunk), reps=5, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "flops": flops, "bytes": moved}


def dense_cache_phase(dev, rate, rows) -> None:
    """Phase 16 (module docstring): mamba2-130m, zamba2-7b, gemma3-12b and
    llama-3.2-vision-90b (20 layers) at full width on the dense decode
    caches, one at a time: prefill, greedy decode steps, the teacher-forced
    forward they are held to, the launches against their prediction, each
    kernel against its plain version on the path's own inputs; then the
    smoke configs on the card against the CPU.  Adds the launches and the
    times to the flash_attention and ssd_scan rows."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.model import DecodeCache, LanguageModel
    from repro_torch.configs import smoke_config
    from repro_torch.serving.crosscheck import (
        dense_cache_card_against_cpu, dense_cache_rejects_planted_faults, dense_tolerance,
    )
    from repro_torch.serving.engine import draw_cast_params

    phase_t0 = time.perf_counter()
    report, counts, shapes = {}, {op: {} for op in DENSE_OPS}, {op: {} for op in DENSE_OPS}
    taps = {"flash_attention": KernelTap(attn_lib.flash_attention), "ssd_scan": KernelTap(ssm_lib.ssd_scan)}
    control = [(cell, "float32") for cell in DENSE_CELLS if cell[0] == F32_CONTROL]
    for (arch, layers, batch, prompt, steps), dtype in [(cell, None) for cell in DENSE_CELLS] + control:
        t_model = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.scaled(n_layers=layers)
        key = arch
        if dtype is not None:
            cfg, key = cfg.scaled(dtype=dtype), f"{arch}_{dtype}"
        lm = LanguageModel(cfg)
        total = prompt + steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_gib = torch.cuda.memory_allocated() / 2**30
        t = time.perf_counter()
        weights = draw_cast_params(lm, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        entry = {"layers": cfg.n_layers, "dtype": cfg.dtype, "batch": batch, "prompt": prompt, "steps": steps,
                 "parameters": sum(int(np.prod(x)) for x in lm.param_specs().values()),
                 "draw_s": time.perf_counter() - t, "before_gib": before_gib,
                 "held_gib": torch.cuda.memory_allocated() / 2**30}
        gen = torch.Generator(device=dev).manual_seed(SEED + 40)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=dev)
        img = None
        if cfg.family == "vlm":
            img = torch.randn((batch, cfg.n_img_tokens, cfg.d_model), generator=gen, device=dev)
        per_pass = predicted_launches(cfg)

        # -- prefill and greedy decode, the counters from 0 -----------------
        dispatch.reset_launch_counts()
        attn_lib.flash_attention, ssm_lib.ssd_scan = taps["flash_attention"], taps["ssd_scan"]
        for tap in taps.values():
            tap.armed, tap.calls = True, []
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = lm.prefill(weights, prompts, total, img)
            torch.cuda.synchronize()
            entry["prefill_s"] = time.perf_counter() - t
        finally:
            for tap in taps.values():
                tap.armed = False
            attn_lib.flash_attention, ssm_lib.ssd_scan = taps["flash_attention"].fn, taps["ssd_scan"].fn
        after_prefill = dispatch.launch_counts()
        require(bool(torch.isfinite(logits).all()) and logits.shape == (batch, prompt, cfg.padded_vocab),
                f"{key}: finite prefill logits over the padded vocabulary")
        last = logits[:, -1].clone()
        del logits
        tok = last.argmax(-1)
        fed, dec, walls = [tok], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = lm.decode_step(weights, tok[:, None], cache)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            dec.append(lg)
            tok = lg.argmax(-1)
            fed.append(tok)
        require(bool((cache.position == total).all()), f"{key}: position {cache.position.tolist()} is {total}")
        require(all(bool(torch.isfinite(lg).all()) for lg in dec), f"{key}: finite decode logits")
        for field in DecodeCache._fields:
            leaf = getattr(cache, field)
            if leaf.is_floating_point() and leaf.numel():
                require(bool(torch.isfinite(leaf).all()), f"{key}: cache {field} finite")
        entry["decode_ms_per_step_median"] = sorted(walls)[len(walls) // 2] * 1e3
        del cache

        # -- the teacher-forced forward over prompt and the fed tokens -------
        seq = torch.cat([prompts, torch.stack(fed[:steps], 1)], dim=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        full = lm.forward(weights, seq, img)[:, prompt - 1 :]
        torch.cuda.synchronize()
        entry["forward_s"] = time.perf_counter() - t
        launches = dispatch.launch_counts()
        gaps = [((last - full[:, 0]).abs().max() / full[:, 0].abs().max()).item()]
        gaps += [((lg - full[:, i + 1]).abs().max() / full[:, i + 1].abs().max()).item() for i, lg in enumerate(dec)]
        agree = torch.stack([full[:, i].argmax(-1) == fed[i] for i in range(steps)])
        del full, dec, weights
        torch.cuda.empty_cache()
        entry.update(
            worst_gap_over_step_max=max(gaps[1:]), prefill_gap_over_step_max=gaps[0],
            greedy_agreement=agree.float().mean().item(),
            launches={op: {"predicted_per_pass": per_pass[op], "after_prefill": after_prefill[op],
                           "after_forward": launches[op]} for op in DENSE_OPS})
        for op in DENSE_OPS:
            require(after_prefill[op] == per_pass[op] and launches[op] == 2 * per_pass[op],
                    f"{key}: {op} launched {after_prefill[op]} times in the prefill and {launches[op]} with "
                    f"the forward, predicted {per_pass[op]} a pass")
            if per_pass[op]:
                counts[op][key] = launches[op]
        print(f"dense {key}: {entry['parameters']} parameters drawn in {entry['draw_s']:.1f} s, device memory "
              f"{entry['before_gib']:.2f} GiB before, {entry['held_gib']:.2f} held after; prefill {batch} x {prompt} in {entry['prefill_s']:.3f} s, {steps} "
              f"greedy steps at {entry['decode_ms_per_step_median']:.2f} ms (median), forward {batch} x {total} "
              f"in {entry['forward_s']:.3f} s; launches (predicted a pass, after prefill, after forward) "
              f"{json.dumps(entry['launches'])}; decode against the forward: worst gap "
              f"{entry['worst_gap_over_step_max']!r} of the step's largest |logit| (prefill "
              f"{entry['prefill_gap_over_step_max']!r}), greedy agreement {entry['greedy_agreement']!r}",
              flush=True)

        # -- each kernel against its plain version on the path's inputs -------
        for op, check in (("flash_attention", flash_case), ("ssd_scan", ssd_case)):
            calls, taps[op].calls = taps[op].calls, []
            if not per_pass[op]:
                continue
            require(len(calls) == 2, f"{key}: the prefill's first and last {op} calls kept")
            cases = [check(rate, call, f"{key} {op} ({which})") for call, which in zip(calls, ("first", "last"))]
            shapes[op][key] = cases
            print(f"dense {key} {op}, the prefill's first and last calls against the plain version: "
                  f"{json.dumps(cases)}", flush=True)
            del calls
        torch.cuda.synchronize()
        entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        entry["model_s"] = time.perf_counter() - t_model
        report[key] = entry
        del img, prompts, seq
        torch.cuda.empty_cache()

    # -- the smoke configs on the card against the CPU path ----------------------
    report["smoke_card_against_cpu"] = {}
    for arch, *_ in DENSE_CELLS:
        dispatch.reset_launch_counts()
        readings = dense_cache_card_against_cpu(dev, arch)
        readings["launches"] = {op: dispatch.launch_counts()[op] for op in DENSE_OPS}
        report["smoke_card_against_cpu"][arch] = readings
        if smoke_config(arch).uses_ssm:  # the SSM limit rejects each planted scan fault on the card
            readings["planted_faults"] = dense_cache_rejects_planted_faults(dev, arch)
    print(f"dense smoke runs: card against the CPU path, each logit within its limit x the step's largest "
          f"(gemma3, vlm {dense_tolerance('gemma3_12b')}; mamba2, zamba2 {dense_tolerance('mamba2_130m')}, "
          f"and each planted scan fault above it): {json.dumps(report['smoke_card_against_cpu'])}", flush=True)

    # -- the card where it used to raise: SSM prompts whose chunk is no
    # multiple of 16 (the scan's dt = 0 tail), bf16 flash at d 16 and 32 --
    report["short_ssm_prompts"] = {}
    for arch in ("mamba2_130m", "zamba2_7b"):
        for s in SHORT_SSM_PROMPTS:
            dispatch.reset_launch_counts()
            readings = dense_cache_card_against_cpu(dev, arch, prompt_len=s)
            readings["ssd_scan_launches"] = dispatch.launch_counts()["ssd_scan"]
            want = predicted_launches(smoke_config(arch))["ssd_scan"]
            require(readings["ssd_scan_launches"] == want,
                    f"{arch} smoke, prompt {s}: {readings['ssd_scan_launches']} ssd_scan launches ({want})")
            report["short_ssm_prompts"][f"{arch}/{s}"] = readings
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    for d in (16, 32):
        b, s, h, kvh = SMALL_HEAD_FLASH
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        shapes["flash_attention"][f"bf16_d{d}"] = flash_case(rate, ((q, k, v), {}), f"bf16 flash at d {d}")
    print(f"dense repairs on the card: smoke SSM prompts of {SHORT_SSM_PROMPTS} within "
          f"{dense_tolerance('mamba2_130m')} of the CPU {json.dumps(report['short_ssm_prompts'])}; bf16 flash "
          f"at d 16 and 32: {json.dumps({k: shapes['flash_attention'][k] for k in ('bf16_d16', 'bf16_d32')})}",
          flush=True)

    for row in rows:
        if row["name"] in DENSE_OPS:
            row["registry_launches"] = row["launches"]
            row["launches"] = sum(counts[row["name"]].values())
            row["dense_cache_launches"] = counts[row["name"]]
            row["dense_cache_shapes"] = shapes[row["name"]]
    report["phase_s"] = time.perf_counter() - phase_t0
    print(json.dumps({"dense_cache": report}), flush=True)


# Phase 17: the sharded store.  The LGSSM at the filter's N, cut to
# SHARDED_T generations, over 1, 2 and 4 in-process shards on the card; the
# store program at SHARDED_STORE_N on the card and on the CPU; a sharded
# SMCDecoder on phase 12's request shape.
SHARDED_T = 256
SHARDED_SHARDS = (1, 2, 4)
SHARDED_STORE_N = 4_096
SHARDED_OPS = ("cow_write", "refcount_update", "cow_gather")
SHARDED_DECODE_SHARDS = 2
SHARDED_DECODE_STEPS = 16
# Resample on every step whose weights are not all equal: 16 steps then
# run the exchange on most steps (phase 12's threshold of 0.5 resamples
# ~0.15 times a step).
SHARDED_DECODE_ESS = 1.0


@contextlib.contextmanager
def sharded_store_calls(last: dict, captured: dict):
    """While open, the store's ``cow_write``, ``refcount_update`` and
    ``cow_gather`` count their calls in ``last["seen"]`` and keep the
    inputs of the call numbered ``last[op]`` (1-based; the data cloned
    before a write) in ``captured``."""
    from repro_torch.core import store as store_lib

    write, update, gather = store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather
    seen = last["seen"] = {op: 0 for op in SHARDED_OPS}

    def keep(op) -> bool:
        seen[op] += 1
        return seen[op] == last.get(op)

    def capture_write(data, src, dst, pos, values):
        if keep("cow_write"):
            captured["cow_write"] = (data.clone(), src.clone(), dst.clone(), pos.clone(), values.clone())
        return write(data, src, dst, pos, values)

    def capture_update(refcount, frozen, new_tables, old_tables, *, do_freeze):
        if keep("refcount_update"):
            captured["refcount_update"] = (new_tables.clone(), old_tables.clone(), refcount.shape[0])
        return update(refcount, frozen, new_tables, old_tables, do_freeze=do_freeze)

    def capture_gather(data, table, out=None):
        if keep("cow_gather"):
            captured["cow_gather"] = (data.clone(), table.clone())
        return gather(data, table, out)

    store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather = (
        capture_write, capture_update, capture_gather)
    try:
        yield captured
    finally:
        store_lib.cow_write, store_lib.refcount_update, store_lib.cow_gather = write, update, gather


def sharded_kernel_cases(rate, captured) -> dict:
    """The sharded path's kept calls against their plain versions (exact),
    with their device times, the plain versions', the library call's and
    the bound (bytes over the memory rate)."""
    from repro_torch.kernels.cow_gather import cow_gather, cow_gather_ref
    from repro_torch.kernels.cow_write import cow_write, cow_write_ref
    from repro_torch.kernels.refcount_update import refcount_delta, refcount_delta_ref

    cases = {}
    data, src, dst, pos, values = captured["cow_write"]
    nb, block_bytes = data.shape[0] - 1, data[0].numel() * data.element_size()
    got = cow_write(data.clone(), src, dst, pos, values)
    want = cow_write_ref(data.clone(), src, dst, pos, values)
    require(torch.equal(got[:nb], want[:nb]) and not got[nb].any(),
            "sharded cow_write equals its plain version on a shard's append")
    scratch_k, scratch_p = data.clone(), data.clone()

    def plain_write():
        cow_write_ref(scratch_p, src, dst, pos, values)
        scratch_p[-1].zero_()

    live = int((dst != nb).sum())
    moved = src.numel() * (3 * 4 + values[0].numel() * values.element_size()) + 2 * (live + 1) * block_bytes
    cases["cow_write"] = {"append": {
        "rows": src.numel(), "pool_blocks": nb, "max_abs_err": 0.0,
        "ms": device_ms(lambda: cow_write(scratch_k, src, dst, pos, values)), "plain_ms": device_ms(plain_write),
        "bound_ms": moved / rate * 1e3, "bound_by": "bytes", "library_ms": None, "bytes": moved}}
    del got, want, scratch_k, scratch_p

    new, old, nb = captured["refcount_update"]
    row = new.shape[-1]
    new, old = new.reshape(-1).contiguous(), old.reshape(-1).contiguous()
    got, want = refcount_delta(new, old, nb, row=row), refcount_delta_ref(new, old, nb)
    require(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
            "sharded refcount_update equals its plain version on a shard's clone_partial")
    new1, old1 = (new + 1).long(), (old + 1).long()
    moved = 2 * old.numel() * 4 + nb * 5
    cases["refcount_update"] = {"clone_partial": {
        "entries": new.numel(), "pool_blocks": nb, "null_share": (new < 0).float().mean().item(),
        "max_abs_err": 0.0, "ms": device_ms(lambda: refcount_delta(new, old, nb, row=row)),
        "plain_ms": device_ms(lambda: refcount_delta_ref(new, old, nb)),
        "bound_ms": moved / rate * 1e3, "bound_by": "bytes", "bytes": moved,
        "library_ms": device_ms(lambda: torch.bincount(new1, minlength=nb + 1) - torch.bincount(old1, minlength=nb + 1))}}

    cases["cow_gather"] = {}
    for key in ("exports", "trajectories"):
        data, table = captured[f"cow_gather_{key}"]
        got, want = cow_gather(data, table), cow_gather_ref(data, table)
        require(torch.equal(got, want), f"sharded cow_gather ({key}) equals its plain version")
        block_bytes = data[0].numel() * data.element_size()
        distinct = int(torch.unique(table[table >= 0]).numel())
        moved = table.numel() * 4 + distinct * block_bytes + table.numel() * block_bytes
        flat, safe = data.reshape(data.shape[0], -1), table.clamp(min=0).long()
        cases["cow_gather"][key] = {
            "entries": table.numel(), "distinct_blocks": distinct, "max_abs_err": 0.0,
            "ms": device_ms(lambda: cow_gather(data, table)), "plain_ms": device_ms(lambda: cow_gather_ref(data, table)),
            "bound_ms": moved / rate * 1e3, "bound_by": "bytes", "bytes": moved,
            "library_ms": device_ms(lambda: torch.index_select(flat, 0, safe))}
        del got, want, flat, safe
    return cases


def sharded_store_program(dev, S, mode) -> list:
    """The store program on ``S`` in-process shards on ``dev``: appends of
    normal items (from numpy's ``SEED + 40``), a clone on uniform random
    ancestors (mostly across shards), a within-shard pair clone,
    ``write_at``, lockstep ``grow`` and ``compact``; returns the stacked
    view's leaves, the trajectories and the per-shard used and peak
    blocks."""
    from repro_torch.core.store import StoreConfig
    from repro_torch.distributed import ShardMesh
    from repro_torch.distributed import sharded_store as tss

    n = SHARDED_STORE_N
    mesh = ShardMesh.in_process(S, dev)
    cfg = tss.ShardedStoreConfig(StoreConfig(mode=mode, n=n, block_size=4, max_blocks=8, item_shape=(1,)), S)
    rng = np.random.default_rng(SEED + 40)

    def tensor(a):
        return torch.as_tensor(a, device=dev)

    st = tss.create(cfg, mesh)
    for t in range(10):
        st = tss.append(cfg, mesh, st, tensor(rng.standard_normal((n, 1)).astype(np.float32)))
        if t == 3:
            st = tss.clone(cfg, mesh, st, tensor(rng.integers(0, n, n).astype(np.int32)))
        elif t == 5:
            st = tss.clone(cfg, mesh, st, tensor((np.arange(n) // 2 * 2).astype(np.int32)))
        elif t == 6:
            st = tss.write_at(cfg, mesh, st, tensor(rng.integers(0, t + 1, n).astype(np.int32)),
                              tensor(rng.standard_normal((n, 1)).astype(np.float32)))
        elif t == 7:
            st = tss.grow(cfg, mesh, st, tss.local_num_blocks(st) + 64)
        elif t == 8:
            st = tss.compact(cfg, mesh, st)
    v = tss.stacked(mesh, st)
    return [*v.pool, v.dense, v.tables, v.lengths, v.peak_blocks, tss.trajectories(cfg, mesh, st),
            tss.used_blocks_per_shard(cfg, mesh, st), tss.peak_blocks_per_shard(cfg, mesh, st)]


def sharded_phase(dev, rate, rows, ys, lm, weights) -> None:
    """Phase 17 (module docstring): the sharded store at the filter's
    scale.  Adds the path's launches and its kernels' cases to the
    ``cow_write``, ``refcount_update`` and ``cow_gather`` rows."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import random as rnd
    from repro_torch.core import store as store_lib
    from repro_torch.core.config import ALL_MODES, CopyMode
    from repro_torch.distributed import ShardMesh
    from repro_torch.distributed import sharded_store as tss
    from repro_torch.kernels import dispatch
    from repro_torch.serving.smc_decode import SMCDecoder, _TokenTrace
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    phase_t0 = time.perf_counter()
    report = {}
    n, steps = N_PARTICLES, SHARDED_T
    obs = ys[:steps]
    ssm = lgssm(rnd, SSMDef)

    # -- the store program, card against CPU --------------------------------
    t = time.perf_counter()
    for S in SHARDED_SHARDS:
        for mode in ALL_MODES:
            card, cpu = sharded_store_program(dev, S, mode), sharded_store_program(torch.device("cpu"), S, mode)
            for i, (a, b) in enumerate(zip(card, cpu, strict=True)):
                require(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b),
                        f"sharded store program, S={S} {mode.value}: leaf {i} equal on card and CPU")
    report["store_program_s"] = time.perf_counter() - t
    print(f"sharded: the store program (N={SHARDED_STORE_N}, block 4, 8 blocks a particle; appends, a "
          f"cross-shard clone, a pair clone, write_at, grow, compact) on {SHARDED_SHARDS} shards in every "
          f"mode: every stacked leaf, the trajectories and the per-shard blocks equal on card and CPU "
          f"({report['store_program_s']:.1f} s)", flush=True)

    # -- the filter at N = 65,536 over 1, 2 and 4 shards ----------------------
    def run(mode, mesh, capture=None):
        cfg = FilterConfig(n_particles=n, n_steps=steps, mode=mode, mesh=mesh)
        pf = ParticleFilter(ssm, cfg, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pf.run(rnd.generator(SEED, dev), None, obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        require(not bool(res.oom), f"sharded filter {mode.value}, {mesh}: oom is False")
        require(math.isfinite(float(res.log_evidence)), f"sharded filter {mode.value}: finite log_evidence")
        return pf, res, wall

    single_pf, single, single_wall = run(CopyMode.LAZY_SR, None)
    report["single_device_ms_per_generation"] = single_wall / steps * 1e3
    runs = {}
    for S in SHARDED_SHARDS:
        mesh = ShardMesh.in_process(S, dev)
        modes = ALL_MODES if S == 4 else (CopyMode.LAZY_SR,)
        for mode in modes:
            last, captured = {}, {}
            path = S == 4 and mode is CopyMode.LAZY_SR
            if path:
                # The path: counters from 0, the last call of each kernel kept.
                last = {"cow_write": S * steps, "refcount_update": S * (steps - 1), "cow_gather": S * (steps - 1)}
                dispatch.reset_launch_counts()
            with sharded_store_calls(last, captured):
                pf, res, wall = run(mode, mesh)
            if path:
                launches = dispatch.launch_counts()
                report["launches"] = {op: launches[op] for op in SHARDED_OPS}
                require(last["seen"] == {op: last[op] for op in SHARDED_OPS},
                        f"sharded store calls {last['seen']}: an append a shard a generation, a clone and an "
                        "export gather a shard a resampling generation")
                for op in SHARDED_OPS:
                    require(launches[op] == last[op], f"{op} launched on the sharded path ({launches[op]})")
                captured["cow_gather_exports"] = captured.pop("cow_gather")
                with sharded_store_calls({"cow_gather": S}, captured):
                    tss.trajectories(pf.sharded_cfg, mesh, res.store)
                captured["cow_gather_trajectories"] = captured.pop("cow_gather")
                kept = captured
            used = tss.used_blocks_per_shard(pf.sharded_cfg, mesh, res.store).tolist()
            peak = tss.peak_blocks_per_shard(pf.sharded_cfg, mesh, res.store).tolist()
            runs[(S, mode)] = (pf, res, mesh)
            key = f"S{S}/{mode.value}"
            report[key] = {"ms_per_generation": wall / steps * 1e3, "log_evidence": float(res.log_evidence),
                           "used_blocks_per_shard": used, "peak_blocks_per_shard": peak,
                           "pool_blocks_per_shard": tss.local_num_blocks(res.store)}
            print(f"sharded filter {key}: N={n} T={steps} wall {wall:.3f} s "
                  f"({wall / steps * 1e3:.3f} ms a generation), log_evidence {float(res.log_evidence)!r}, "
                  f"used blocks per shard {used}, peak {peak}", flush=True)
    bits = {m.value: runs[(4, m)][1].log_evidence.view(torch.int32).item() for m in ALL_MODES}
    require(len(set(bits.values())) == 1, f"4 shards: log_evidence bit-identical across modes {bits}")
    (pf_e, eager, mesh4), (pf_s, sr, _) = runs[(4, CopyMode.EAGER)], runs[(4, CopyMode.LAZY_SR)]
    require(torch.equal(tss.trajectories(pf_e.sharded_cfg, mesh4, eager.store),
                        tss.trajectories(pf_s.sharded_cfg, mesh4, sr.store)),
            "4 shards: LAZY_SR trajectories equal EAGER's")
    used = {m.value: sum(report[f"S4/{m.value}"]["used_blocks_per_shard"]) for m in ALL_MODES}
    require(used["lazy_sr"] < 0.6 * used["eager"], f"4 shards: LAZY_SR's blocks below 0.6 x EAGER's {used}")

    # S = 1 against the single-device run, leaf for leaf.
    def leaves(v):
        return [*v.pool, v.dense, v.tables, v.lengths, v.peak_blocks]

    pf1, one, mesh1 = runs[(1, CopyMode.LAZY_SR)]
    v = leaves(tss.stacked(mesh1, one.store))
    require(single.log_evidence.view(torch.int32).item() == one.log_evidence.view(torch.int32).item()
            and all(torch.equal(a.reshape(b.shape), b) for a, b in zip(leaves(single.store), v, strict=True))
            and torch.equal(single.log_weights, one.log_weights),
            "1 shard: bit-exact with the single-device filter (log_evidence, log-weights, every store leaf)")

    # The NCCL process group at world size 1 against the in-process shard
    # (gloo when the phase is rehearsed on the CPU).
    with tempfile.TemporaryDirectory() as where:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{os.path.join(where, 'rendezvous')}",
                                world_size=1, rank=0)
        try:
            pmesh = ShardMesh.process_group(device=dev)
            ppf, pres, pwall = run(CopyMode.LAZY_SR, pmesh)
            pv = leaves(tss.stacked(pmesh, pres.store))
        finally:
            dist.destroy_process_group()
    require(pres.log_evidence.view(torch.int32).item() == one.log_evidence.view(torch.int32).item()
            and all(torch.equal(a, b) for a, b in zip(pv, v, strict=True)),
            "NCCL process group of 1 rank: bit-equal to the in-process shard")
    report["nccl_world_1_ms_per_generation"] = pwall / steps * 1e3
    del pres, pv, v, one, single, runs, eager, sr
    print(f"sharded: 4 shards bit-identical across modes (log_evidence {bits}); LAZY_SR's blocks "
          f"{used['lazy_sr']} below 0.6 x EAGER's {used['eager']}; 1 shard bit-exact with the single-device "
          f"run; the NCCL group of 1 rank bit-equal to it", flush=True)

    # -- the exchange's bytes a generation at 4 shards ------------------------
    capacity = pf_s.sharded_cfg.base.capacity
    k, S = pf_s.sharded_cfg.exports, 4
    item = 4  # float32 items of shape (1,)
    report["exchange_bytes_per_generation"] = {
        "exports_materialized": S * k * capacity * item,
        "all_gather_read_and_written": 2 * S * k * capacity * item,
        "imports_gathered_read_and_written": 2 * n * capacity * item,
    }
    report["exchange_bytes_per_generation"]["total"] = sum(report["exchange_bytes_per_generation"].values())

    # -- the kernels on the path's own inputs -------------------------------
    cases = sharded_kernel_cases(rate, kept)
    del kept
    print(f"sharded kernels on the path's inputs (4 shards, LAZY_SR, last generation): {json.dumps(cases)}",
          flush=True)

    # -- the token trace's import skew --------------------------------------
    mesh = ShardMesh.in_process(4, dev)
    tr = _TokenTrace(8, 16, CopyMode.LAZY_SR, 2, mesh)
    for t in range(8):
        tr.append(torch.full((8,), t, dtype=torch.int32, device=dev))
    want = tr.tokens(8)
    live = int(tss.used_blocks_per_shard(tr.shcfg, mesh, tr.store).max())
    tr.store = tss.compact(tr.shcfg, mesh, tr.store, new_num_blocks=live)
    anc = torch.full((8,), 7, dtype=torch.int32, device=dev)
    grew = tr.ensure_clone_headroom(anc, 2.0)
    tr.clone(anc)
    require(grew == 1 and not tr.oom() and torch.equal(tr.tokens(8), want[7].expand(8, 8)),
            f"token trace import skew: grew {grew} (1), oom {tr.oom()}, histories exact")

    # -- a sharded SMCDecoder on phase 12's request shape ---------------------
    prompt = torch.randint(0, lm.cfg.vocab_size, (SMC_PROMPT_LEN,),
                           generator=torch.Generator(device=dev).manual_seed(SEED + 20), device=dev)
    decoded = {}
    for shards in (None, SHARDED_DECODE_SHARDS):
        mesh = None if shards is None else ShardMesh.in_process(shards, dev)
        dec = SMCDecoder(lm, weights, SMC_PARTICLES, max_len=SMC_PROMPT_LEN + SHARDED_DECODE_STEPS + 16,
                         block_size=SERVE_BLOCK, target_temp=SMC_TARGET_TEMP, proposal_temp=SMC_PROPOSAL_TEMP,
                         ess_threshold=SHARDED_DECODE_ESS, mesh=mesh, device=None if mesh is not None else dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        decoded[shards] = dec.run(torch.Generator(device=dev).manual_seed(SEED + 21), prompt, SHARDED_DECODE_STEPS)
        torch.cuda.synchronize()
        report[f"decode_{shards or 'unsharded'}_ms_per_step"] = (time.perf_counter() - t) / SHARDED_DECODE_STEPS * 1e3
        del dec
    plain, sharded = decoded[None], decoded[SHARDED_DECODE_SHARDS]
    for f in ("tokens", "log_weights", "log_evidence", "resampled"):
        require(torch.equal(getattr(plain, f), getattr(sharded, f)),
                f"sharded SMCDecoder ({SHARDED_DECODE_SHARDS} shards): {f} bit-equal to the unsharded one")
    require(int(sharded.resampled.sum()) > 0 and not bool(sharded.oom),
            "sharded SMCDecoder: resampled (the exchange ran), oom False")
    report["decode_resamples"] = int(sharded.resampled.sum())
    del decoded, plain, sharded

    for row in rows:
        if row["name"] in SHARDED_OPS:
            row["sharded_launches"] = report["launches"][row["name"]]
            row["sharded_shapes"] = cases[row["name"]]
    report["phase_s"] = time.perf_counter() - phase_t0
    print(json.dumps({"sharded": report}), flush=True)


# Phase 18: training.  The backward kernels against their plain versions at
# the shapes of the models' training steps, then mamba2-130m through
# Trainer (launch/train.py), starcoder2-3b through make_train_step at its
# published widths, and the smoke families card against the CPU.
TRAIN_FLASH_CASES = (  # (what, [B, S, H, KVH, d], dtype, window)
    ("starcoder2-3b", (2, 4096, 24, 2, 128), torch.bfloat16, 0),
    ("gemma3-12b local layer", (1, 4096, 16, 8, 256), torch.bfloat16, 1024),
    # zamba2-7b's prefill shape: d 112, the width whose last 16 columns TMA
    # fills with zeros.
    ("zamba2-7b prefill", (4, 960, 32, 32, 112), torch.bfloat16, 0),
    ("f32 d 16", (2, 512, 8, 2, 16), torch.float32, 0),
    ("f32 d 32", (2, 512, 8, 2, 32), torch.float32, 0),
)
# mamba2-130m's 24 heads, P 64, N 128, chunk 64, f32, at a training
# microbatch of 2 x 4,096.
TRAIN_SSD_SHAPE = (2, 4096, 24, 64, 128)
# Each gradient within this share of its plain version's largest magnitude:
# f32 sums of up to S terms in another order; bf16 inputs and outputs (the
# forward check's 2e-2).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# mamba2-130m through Trainer: sequence 4,096, global batch 8 in 4
# microbatches of 2, f32 master weights, 6 steps, a checkpoint at step 3,
# then a crash at step 4 and a relaunch.  The synthetic corpus draws from
# 4,096 of the model's 50,280 tokens: its transition matrix is
# vocabulary-squared (20 GB of host memory at the full vocabulary).
TRAIN_CELL = {"arch": "mamba2_130m", "seq": 4096, "batch": 8, "micro": 4, "steps": 6, "every": 3,
              "crash_at": 4, "data_vocab": 4096}
# starcoder2-3b at its published widths: one microbatch of 2 x 4,096, 3 steps.
BIG_TRAIN = {"arch": "starcoder2_3b", "batch": 2, "seq": 4096, "steps": 3}
TRAIN_FAMILIES = ("starcoder2_3b", "mamba2_130m", "zamba2_7b", "gemma3_12b", "deepseek_moe_16b",
                  "musicgen_large", "llama32_vision_90b")
SMOKE_TRAIN = (4, 64)  # batch, sequence of the smoke families' step
# Card against CPU at smoke width (f32): the loss to 1e-5 and the grad norm
# to 1e-4 of their CPU values; the first moment (0.1 x the clipped
# gradient) within 1e-3 of its largest magnitude (the card's SSD forward
# multiplies on the tensor cores in TF32); the updated params within 1e-2
# of the learning rate wherever |mu| is above 1e-2 of its largest (the
# first Adam step moves a param by about lr whatever |g| is, so only where
# the gradient's sign is clear).
SMOKE_TRAIN_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "mu": 1e-3, "param_over_lr": 1e-2, "mu_floor": 1e-2}
TRAIN_OPS = ("flash_attention", "ssd_scan", "flash_attention_bwd", "ssd_scan_bwd")


def grad_ratio(got, want) -> float:
    """The worst |got - want| of each gradient over its plain version's
    largest magnitude (or a hundredth of the call's largest gradient where
    that is more: a gradient that is 0 in exact arithmetic reads the
    rounding of the forward's output, as ``tests/test_torch_boundaries.py``'s
    ``grads_within``)."""
    largest = max(w.abs().max().item() for w in want if w.numel())
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if w.numel():
            worst = max(worst, (g.float() - w.float()).abs().max().item()
                        / max(w.abs().max().item(), 1e-2 * largest))
    return worst


def flash_bwd_case(dev, rate, gen, what, shape, dtype, window) -> dict:
    """flash_attention_bwd against its plain version (autograd of the plain
    forward) on the card, a repeat call bit-equal, two planted faults above
    the limit; its time, the plain version's, SDPA's backward and the bound;
    flash's forward plus backward against SDPA's."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention.ops import forward_lse, tensor_core_route

    b, s, h, kvh, d = shape
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    # The tensor-core backward reads the forward's row log-sum-exp: a direct
    # call is given it by forward_lse, autograd by the Function, which keeps
    # it.  Two direct calls bit-equal, and autograd's gradients equal to theirs.
    tc = dev.type == "cuda" and tensor_core_route(dtype, d)
    out, lse = forward_lse(q, k, v, window=window) if tc else (flash_attention(q, k, v, window=window), None)
    got = flash_attention_bwd(q, k, v, out, dout, window=window, lse=lse)
    again = flash_attention_bwd(q, k, v, out, dout, window=window, lse=lse)
    require(all(torch.equal(x, y) for x, y in zip(got, again, strict=True)), f"{what}: two calls bit-equal")
    fl = [t.detach().requires_grad_() for t in (q, k, v)]
    again = torch.autograd.grad(flash_attention(*fl, window=window), fl, dout)
    require(all(torch.equal(x, y) for x, y in zip(got, again, strict=True)),
            f"{what}: autograd through flash_attention bit-equal to a direct call")
    del again, fl
    want = flash_attention_bwd_ref(q, k, v, dout, window=window)
    tol = BWD_TOL[dtype]
    ratio = grad_ratio(got, want) / tol
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want, strict=True))
    require(all(bool(torch.isfinite(g).all()) for g in got), f"{what}: finite gradients")
    require(ratio <= 1.0, f"{what}: within {tol} of its plain version ({ratio} of the limit)")
    faults = {}
    bad = dout.clone()
    bad[:, -64:] = 0
    faults["last query tile's dO dropped"] = grad_ratio(flash_attention_bwd_ref(q, k, v, bad, window=window), want) / tol
    bad = k.clone()
    bad[:, :64] = 0
    faults["first key tile's K zeroed"] = grad_ratio(flash_attention_bwd_ref(q, bad, v, dout, window=window), want) / tol
    del bad, want, got
    require(min(faults.values()) > 1.0, f"{what}: the check rejects each planted fault {faults}")
    pairs = attention_pairs(s, window) * b * h
    moved = q.element_size() * (4 * q.numel() + 4 * k.numel())
    flops = 10 * d * pairs
    bytes_ms = moved / rate * 1e3
    ops_ms = flops / (BF16_RATE if dtype == torch.bfloat16 else F32_RATE) * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if window:
        i = torch.arange(s, device=dev)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    dot = dout.transpose(1, 2)

    def sdpa_fwd():
        if mask is None:
            return sdpa(*leaves, is_causal=True, enable_gqa=True)
        return sdpa(*leaves, attn_mask=mask, enable_gqa=True)

    kept = sdpa_fwd()
    library_ms = device_ms(lambda: torch.autograd.grad(kept, leaves, dot, retain_graph=True), reps=5)
    sdpa_both_ms = device_ms(lambda: torch.autograd.grad(sdpa_fwd(), leaves, dot), reps=5)
    del kept
    fl = [t.detach().requires_grad_() for t in (q, k, v)]
    flash_both_ms = device_ms(lambda: torch.autograd.grad(flash_attention(*fl, window=window), fl, dout), reps=5)
    case = {
        "what": what, "shape": [b, s, h, kvh, d], "dtype": str(dtype).split(".")[-1], "window": window,
        "route": "tensor cores, wgmma (bf16 P and dS)" if tc else "CUDA cores, f32",
        "max_abs_err": err, "tolerance_ratio": ratio, "fault_ratios": faults,
        "ms": device_ms(lambda: flash_attention_bwd(q, k, v, out, dout, window=window, lse=lse), reps=5),
        "plain_ms": device_ms(lambda: flash_attention_bwd_ref(q, k, v, dout, window=window), reps=2, warmup=1),
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "flash_fwd_bwd_ms": flash_both_ms, "sdpa_fwd_bwd_ms": sdpa_both_ms,
        "flops": flops, "bytes": moved,
    }
    case["tflops"] = flops / case["ms"] / 1e9
    return case


def ssd_bwd_case(dev, rate, gen) -> dict:
    """ssd_scan_bwd against its plain version on the card at mamba2-130m's
    training shape, with the final state's gradient; a repeat call
    bit-equal; two planted faults above the limit; its times and bound."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_ref

    b, s, h, p, n = TRAIN_SSD_SHAPE
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))
    bm, cm = (torch.randn((b, s, n), generator=gen, device=dev) for _ in range(2))
    dy = torch.randn((b, s, h, p), generator=gen, device=dev)
    dh = torch.randn((b, h, p, n), generator=gen, device=dev)
    args = (x, dt, a, bm, cm, dy, dh)
    got = ssd_scan_bwd(*args)
    again = ssd_scan_bwd(*args)
    require(all(torch.equal(u, w) for u, w in zip(got, again, strict=True)), "ssd_scan_bwd: two calls bit-equal")
    del again
    want = ssd_scan_bwd_ref(*args)
    tol = BWD_TOL[torch.float32]
    ratio = grad_ratio(got, want) / tol
    err = max((g - w).abs().max().item() for g, w in zip(got, want, strict=True))
    require(all(bool(torch.isfinite(g).all()) for g in got), "ssd_scan_bwd: finite gradients")
    require(ratio <= 1.0, f"ssd_scan_bwd: within {tol} of its plain version ({ratio} of the limit)")
    faults = {}
    r16 = [t.to(torch.bfloat16).float() for t in (bm, cm)]
    faults["B and C rounded to bf16"] = grad_ratio(ssd_scan_bwd_ref(x, dt, a, *r16, dy, dh), want) / tol
    bad = dy.clone()
    bad[:, -64:] = 0
    faults["last chunk's dy dropped"] = grad_ratio(ssd_scan_bwd_ref(x, dt, a, bm, cm, bad, dh), want) / tol
    del bad, r16, want, got
    require(min(faults.values()) > 1.0, f"ssd_scan_bwd: the check rejects each planted fault {faults}")
    q = 64
    fwd_flops = 2 * b * h * (s // q) * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
    flops = int(2.5 * fwd_flops)
    moved = 4 * (2 * sum(t.numel() for t in args[:5]) + dy.numel() + dh.numel())
    bytes_ms, ops_ms, f32_ms = moved / rate * 1e3, flops / TF32_RATE * 1e3, flops / F32_RATE * 1e3
    case = {
        "shape": [b, s, h, p, n], "chunk": q, "route": "tensor cores, mma.sync TF32 (hi + lo, three passes)",
        "max_abs_err": err, "tolerance_ratio": ratio, "fault_ratios": faults,
        "ms": device_ms(lambda: ssd_scan_bwd(*args), reps=5),
        "plain_ms": device_ms(lambda: ssd_scan_bwd_ref(*args), reps=2, warmup=1),
        # The bound at the kernel's route, TF32 on the tensor cores, as
        # ssd_scan's row; and at the f32 CUDA-core rate, as the CUDA-core
        # version's row had it.
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_f32_ms": max(bytes_ms, f32_ms), "bound_f32_by": "bytes" if bytes_ms >= f32_ms else "operations",
        "library_ms": None, "flops": flops, "bytes": moved,
    }
    case["tflops"] = flops / case["ms"] / 1e9
    return case


def trainer_cell(dev, dispatch) -> dict:
    """mamba2-130m uncut through Trainer, as ``python -m
    repro_torch.launch.train --full`` runs it, under deterministic
    algorithms: the uninterrupted run, then the same run crashed at
    TRAIN_CELL["crash_at"] and relaunched; the resumed losses and the final
    params and moments bit-equal to the uninterrupted run's."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.train_loop import InjectedFailure

    c = TRAIN_CELL
    cfg = get_config(c["arch"])
    args = ["--arch", c["arch"], "--full", "--device", dev.type, "--seq-len", str(c["seq"]),
            "--batch", str(c["batch"]), "--microbatches", str(c["micro"]), "--steps", str(c["steps"]),
            "--checkpoint-every", str(c["every"]), "--log-every", "1", "--data-vocab", str(c["data_vocab"])]
    entry = {"cell": dict(c), "layers": cfg.n_layers}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launch_counts()
            t = time.perf_counter()
            full = train_cli.main(args + ["--checkpoint-dir", f"{tmp}/a"])
            torch.cuda.synchronize()
            entry["wall_s"] = time.perf_counter() - t
            launches = {op: dispatch.launch_counts()[op] for op in TRAIN_OPS}
            entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            try:
                train_cli.main(args + ["--checkpoint-dir", f"{tmp}/b", "--crash-at", str(c["crash_at"])])
                require(False, "the crashed run raised InjectedFailure")
            except InjectedFailure:
                pass
            resumed = train_cli.main(args + ["--checkpoint-dir", f"{tmp}/b"])
    finally:
        torch.use_deterministic_algorithms(was)
    hist = full.history
    per_step = cfg.n_layers * c["micro"]
    require(launches["ssd_scan_bwd"] == c["steps"] * per_step and launches["ssd_scan"] == 2 * c["steps"] * per_step
            and launches["flash_attention_bwd"] == launches["flash_attention"] == 0,
            f"trainer: ssd_scan_bwd once and ssd_scan twice a layer a microbatch ({launches})")
    require(all(math.isfinite(x) for x in hist["loss"] + full.grad_norms), "trainer: finite losses and grad norms")
    start = c["every"]
    require(resumed.history["step"] == hist["step"][start:], f"trainer: resumed at step {start}")
    require(resumed.history["loss"] == hist["loss"][start:],
            f"trainer: resumed losses {resumed.history['loss']} equal {hist['loss'][start:]} bit for bit")
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(full.final_state), tree_leaves(resumed.final_state),
                                                 strict=True))
    require(same, "trainer: the resumed run's final params and moments equal the uninterrupted run's")
    tokens = c["batch"] * c["seq"]
    entry.update(losses=hist["loss"], grad_norms=full.grad_norms, step_walls_s=hist["time"],
                 resumed_losses=resumed.history["loss"], tokens_per_s=tokens / float(np.median(hist["time"][1:])),
                 launches=launches, resumed_equal=True, entropy_floor=full.data.entropy_rate)
    del full, resumed
    return entry


def big_train_cell(dev, dispatch) -> dict:
    """starcoder2-3b at its published widths through make_train_step: f32
    master weights and moments, the bf16 compute copy, bf16 gradients,
    per-layer remat, one microbatch; finite losses and grad norms, the
    launches a step, the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import LanguageModel
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    c = BIG_TRAIN
    cfg = get_config(c["arch"])
    lm = LanguageModel(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    entry = {"cell": dict(c), "parameters": cfg.param_count(), "init_s": time.perf_counter() - t,
             "remat": cfg.remat, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
             "held_gib": torch.cuda.memory_allocated() / 2**30}
    step = make_train_step(lm, AdamWConfig(), n_micro=1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    walls, losses, norms, per_step = [], [], [], []
    for _ in range(c["steps"]):
        seq = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"] + 1), generator=gen, device=dev)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        dispatch.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        per_step.append({op: dispatch.launch_counts()[op] for op in TRAIN_OPS})
    entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(x) for x in losses + norms), f"starcoder2-3b: finite losses {losses}, norms {norms}")
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention_bwd": cfg.n_layers, "ssd_scan": 0, "ssd_scan_bwd": 0}
    require(all(counts == want for counts in per_step),
            f"starcoder2-3b: flash_attention_bwd once and flash_attention twice a layer a step {per_step}")
    entry.update(losses=losses, grad_norms=norms, step_walls_s=walls,
                 tokens_per_s=c["batch"] * c["seq"] / float(np.median(walls[1:])), launches_per_step=per_step[0],
                 launches={op: sum(x[op] for x in per_step) for op in TRAIN_OPS})
    del params, opt
    return entry


def smoke_train_card_against_cpu(dev, dispatch, arch) -> dict:
    """One make_train_step of ``arch``'s smoke config from the same params
    and batch on the card and on the CPU: loss, grad norm, first moment and
    updated params within SMOKE_TRAIN_TOL, and the card's launches."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import LanguageModel
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_leaves, tree_map

    cfg = smoke_config(arch)
    lm = LanguageModel(cfg)
    opt_cfg = AdamWConfig()
    base = lm.init(torch.Generator().manual_seed(SEED), device="cpu")
    bsz, s = SMOKE_TRAIN
    rng = np.random.default_rng(SEED + 70)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, (bsz, s + 1)).astype(np.int32))
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.family == "vlm":
        batch["img"] = torch.as_tensor(rng.standard_normal((bsz, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    out = {}
    for where in ("cpu", dev.type):
        params = tree_map(lambda x: x.clone().to(where), base)
        opt = adamw_init(params)
        dispatch.reset_launch_counts()
        params, opt, metrics = make_train_step(lm, opt_cfg, n_micro=1)(
            params, opt, {k: v.to(where) for k, v in batch.items()})
        out[where] = (tree_leaves(params), tree_leaves(opt.mu), metrics, dispatch.launch_counts())
    (p_cpu, mu_cpu, m_cpu, _), (p_dev, mu_dev, m_dev, counts) = out["cpu"], out[dev.type]
    mu_max = max(x.abs().max().item() for x in mu_cpu)
    mu_err = max((a.cpu() - b).abs().max().item() for a, b in zip(mu_dev, mu_cpu, strict=True)) / mu_max
    sure = [b.abs() > SMOKE_TRAIN_TOL["mu_floor"] * mu_max for b in mu_cpu]
    p_err = max(((a.cpu() - b).abs()[m].max().item() if m.any() else 0.0)
                for a, b, m in zip(p_dev, p_cpu, sure, strict=True)) / opt_cfg.learning_rate
    loss_err = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
    norm_err = abs(float(m_dev["grad_norm"]) - float(m_cpu["grad_norm"])) / float(m_cpu["grad_norm"])
    readings = {"loss": float(m_dev["loss"]), "loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
                "mu_err_over_max": mu_err, "param_err_over_lr": p_err,
                "launches": {op: counts[op] for op in TRAIN_OPS}}
    t = SMOKE_TRAIN_TOL
    require(math.isfinite(readings["loss"]) and math.isfinite(float(m_dev["grad_norm"])), f"{arch} smoke: finite")
    require(loss_err <= t["loss"] and norm_err <= t["grad_norm"] and mu_err <= t["mu"] and p_err <= t["param_over_lr"],
            f"{arch} smoke train step: card against the CPU {readings}")
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
    ssm = cfg.n_layers if cfg.uses_ssm else 0
    want = {"flash_attention": attn, "flash_attention_bwd": attn, "ssd_scan": ssm, "ssd_scan_bwd": ssm}
    require(readings["launches"] == want, f"{arch} smoke: launches {readings['launches']}, expected {want}")
    return readings


def train_phase(dev, rate, rows) -> None:
    """Phase 18 (module docstring): the backward kernels against their plain
    versions and timed; mamba2-130m through Trainer with a crash and a
    relaunch; starcoder2-3b through make_train_step; the smoke families
    card against the CPU.  Adds the flash_attention_bwd and ssd_scan_bwd
    rows."""
    from repro_torch.kernels import dispatch

    phase_t0 = time.perf_counter()
    report = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    flash_cases = [flash_bwd_case(dev, rate, gen, *case) for case in TRAIN_FLASH_CASES]
    for case in flash_cases:
        print(f"train: flash_attention_bwd {case['what']} {case['dtype']} d {case['shape'][-1]}: {case['route']}, "
              f"{case['ms']} ms", flush=True)
    print(f"train: flash_attention_bwd against its plain version {json.dumps(flash_cases)}", flush=True)
    settle()
    ssd = ssd_bwd_case(dev, rate, gen)
    print(f"train: ssd_scan_bwd: {ssd['route']}, {ssd['ms']} ms", flush=True)
    print(f"train: ssd_scan_bwd against its plain version {json.dumps(ssd)}", flush=True)
    settle()
    report["trainer"] = trainer_cell(dev, dispatch)
    print(f"train: {TRAIN_CELL['arch']} through Trainer {json.dumps(report['trainer'])}", flush=True)
    settle()
    report["make_train_step"] = big_train_cell(dev, dispatch)
    print(f"train: {BIG_TRAIN['arch']} through make_train_step {json.dumps(report['make_train_step'])}", flush=True)
    settle()
    report["smoke_card_against_cpu"] = {arch: smoke_train_card_against_cpu(dev, dispatch, arch)
                                        for arch in TRAIN_FAMILIES}
    print(f"train: smoke families card against the CPU {json.dumps(report['smoke_card_against_cpu'])}", flush=True)

    first = flash_cases[0]
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda", "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "none: the gradient of src/repro/kernels/flash_attention/kernel.py:94, which the "
                    "reference takes through plain attention_chunked",
        "launches": report["make_train_step"]["launches"]["flash_attention_bwd"],
        "max_abs_err": first["max_abs_err"], "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "train_shapes": flash_cases,
    })
    rows.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "none: the gradient of src/repro/kernels/ssd_scan/kernel.py:92, which the reference "
                    "takes through plain ssd_chunked",
        "launches": report["trainer"]["launches"]["ssd_scan_bwd"],
        "max_abs_err": ssd["max_abs_err"], "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"], "bound_f32_ms": ssd["bound_f32_ms"],
        "library_ms": None, "train_shapes": [ssd],
    })
    report["phase_s"] = time.perf_counter() - phase_t0
    print(json.dumps({"train": report}), flush=True)


def settle() -> None:
    """Between phases: collect Python's cyclic garbage, then return the
    cached blocks, so a phase starts with only what is still referenced.
    Without the collection, a finished phase's schedulers and engines
    (caught exceptions' frames among them) can keep their weights on the
    card: 6.53 GiB when phase 15 began in one run."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import random as rnd
    from repro_torch.core import store as store_lib
    from repro_torch.core.config import ALL_MODES, CopyMode
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.clone_chain import clone_chain_kernel, clone_chain_ref, weights_cdf
    from repro_torch.kernels.cow_gather import cow_gather, cow_gather_ref
    from repro_torch.kernels.cow_write import cow_write, cow_write_ref
    from repro_torch.kernels.refcount_update import refcount_delta, refcount_delta_ref
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rate = memory_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}", flush=True)
    for fn, regs, stores, loads in ptxas_report((lib.parent / "build.log").read_text()):
        print(f"  ptxas {fn}: {regs} registers, spill stores {stores} B, loads {loads} B", flush=True)

    # -- 2. the main path ---------------------------------------------------
    n, steps = N_PARTICLES, N_STEPS
    ys = np.random.default_rng(SEED).standard_normal(steps).astype(np.float32)
    ssm = lgssm(rnd, SSMDef)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    phase_counts = {}
    results = {}

    def run(mode, resampler="systematic"):
        cfg = FilterConfig(n_particles=n, n_steps=steps, mode=mode, resampler=resampler)
        pf = ParticleFilter(ssm, cfg, device=dev)
        before = dispatch.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pf.run(rnd.generator(SEED, dev), None, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = dispatch.launch_counts()
        phase_counts[f"{mode.value}/{resampler}"] = {k: after[k] - before[k] for k in after}
        logz = float(res.log_evidence)
        print(
            f"run mode={mode.value} resampler={resampler} N={n} T={steps} "
            f"wall_s={wall:.3f} log_evidence={logz!r} "
            f"peak_blocks={int(res.store.peak_blocks)} pool_blocks={res.store.pool.num_blocks} "
            f"oom={bool(res.oom)}",
            flush=True,
        )
        require(math.isfinite(logz), f"{mode.value}: finite log_evidence")
        require(not bool(res.oom), f"{mode.value}: oom is False")
        require(res.ess_trace.shape == (steps,), "ess trace shape")
        return pf, res

    for mode in ALL_MODES:
        results[mode] = run(mode)
    logz_bits = {m: results[m][1].log_evidence.view(torch.int32).item() for m in ALL_MODES}
    require(len(set(logz_bits.values())) == 1, f"log_evidence bit-identical across modes {logz_bits}")
    dense_blocks = n * steps // 4
    for mode in (CopyMode.LAZY, CopyMode.LAZY_SR):
        peak = int(results[mode][1].store.peak_blocks)
        require(peak < dense_blocks, f"{mode.value} peak {peak} < dense {dense_blocks}")

    eager_pf, eager = results[CopyMode.EAGER]
    sr_pf, sr = results[CopyMode.LAZY_SR]
    ids = torch.arange(n, device=dev)
    dense = eager.store.dense[:, :steps]
    trajs = store_lib.materialize_batch(sr_pf.store_cfg, sr.store, ids)
    require(torch.equal(trajs[:, :steps], dense), "LAZY_SR materialize_batch == EAGER dense")
    compacted = store_lib.compact(sr_pf.store_cfg, sr.store)
    trajs = store_lib.materialize_batch(sr_pf.store_cfg, compacted, ids)
    require(torch.equal(trajs[:, :steps], dense), "after compact: materialize_batch == EAGER dense")
    require(not bool(compacted.pool.oom), "compact keeps oom False")
    print(
        f"materialize_batch: {n} x {steps} trajectories equal EAGER's before and after "
        f"compact (live blocks {int(store_lib.used_blocks(sr_pf.store_cfg, compacted))})",
        flush=True,
    )
    del trajs, compacted, dense, eager, results[CopyMode.EAGER], results[CopyMode.LAZY_SR]
    run(CopyMode.LAZY, "stratified")
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"launches per run: {json.dumps(phase_counts)}", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for op in FILTER_OPS:
        require(launches[op] > 0, f"kernel {op} launched on the filter's path ({launches[op]})")

    # -- 3. kernels against their plain versions ---------------------------
    lazy_pf, lazy = results[CopyMode.LAZY]
    tables = lazy.store.tables
    pool = lazy.store.pool
    nb, mb = pool.num_blocks, tables.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rows = []
    # The path's final tables are full; a copy with 1/16 of the entries
    # NULL holds the kernels to the NULL case as well.
    null_tables = torch.where(
        torch.rand(tables.shape, generator=gen, device=dev) < 1 / 16, -1, tables
    ).to(torch.int32)

    def exact(got, want, what):
        for a, b in zip(got, want, strict=True):
            require(torch.equal(a, b), f"{what}: kernel equals its plain version")

    def report(op, replaces, source, got, want, fn, plain_fn, bytes_moved,
               ops=0.0, library_fn=None):
        diffs = [
            (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
            for a, b in zip(got, want, strict=True)
        ]
        err = max(diffs)
        require(err == 0.0, f"{op}: kernel equals its plain version (max |diff| {err})")
        # Device time per call of the wrapper, of the plain version and of
        # the library call; call_ms is the wrapper's time per call between
        # CUDA events with the host's launch gaps included.
        ms = device_ms(fn)
        plain_ms = device_ms(plain_fn)
        library_ms = device_ms(library_fn) if library_fn is not None else None
        call_ms = time_ms(fn)
        bytes_ms = bytes_moved / rate * 1e3
        ops_ms = ops / F32_RATE * 1e3
        rows.append({
            "name": op,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[op],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "call_ms": call_ms,
        })
        print(f"kernel {op}: exact; {ms:.4f} ms on the device, {call_ms:.4f} ms per call "
              f"(plain {plain_ms:.4f} ms)", flush=True)

    # cow_write: an append's routing at N rows — copy rows (several per
    # shared source), in-place rows, masked rows on the dump row.
    data = pool.data.clone()
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    fresh, shared = perm[:n], perm[n : n + 4096]
    kind = torch.randint(0, 3, (n,), generator=gen, device=dev)
    pick = torch.randint(0, shared.numel(), (n,), generator=gen, device=dev)
    src = torch.where(kind == 0, shared[pick], fresh)
    dst = fresh.clone()
    src = torch.where(kind == 2, nb, src).to(torch.int32)
    dst = torch.where(kind == 2, nb, dst).to(torch.int32)
    pos = torch.randint(0, 4, (n,), generator=gen, device=dev, dtype=torch.int32)
    values = torch.randn((n, 1), generator=gen, device=dev)
    got = cow_write(data.clone(), src, dst, pos, values)
    want = cow_write_ref(data.clone(), src, dst, pos, values)
    require(not got[nb].any(), "cow_write leaves the dump row zero")
    dirty = data.clone()
    dirty[nb] = 1.0
    require(not cow_write(dirty, src, dst, pos, values)[nb].any() and torch.equal(dirty[:nb], got[:nb]),
            "cow_write zeroes a dump row that held data on entry, in its one launch")
    del dirty
    live_rows = int((kind != 2).sum())
    scratch_k, scratch_p = data.clone(), data.clone()

    def plain_write():
        cow_write_ref(scratch_p, src, dst, pos, values)
        scratch_p[-1].zero_()

    report(
        "cow_write", "src/repro/kernels/cow_write/kernel.py:123",
        "src/repro_torch/csrc/cow_write.cu", [got[:nb]], [want[:nb]],
        lambda: cow_write(scratch_k, src, dst, pos, values), plain_write,
        bytes_moved=n * (3 * 4 + 4) + 2 * (live_rows + 1) * 16,
    )
    del data, scratch_k, scratch_p, got, want

    # refcount_update: a resampling step's clone of the LAZY run's final
    # tables (stratified ancestors from its final weights).
    logw = lazy.log_weights
    cum = weights_cdf(logw)
    anc = torch.searchsorted(cum, (torch.arange(n, device=dev) + torch.rand(n, generator=gen, device=dev)) / n)
    old = tables.reshape(-1).contiguous()
    new = tables[anc.clamp(max=n - 1)].reshape(-1).contiguous()
    got = refcount_delta(new, old, nb, row=mb)
    want = refcount_delta_ref(new, old, nb)
    # The kernel's premise: a column repeats a block down the particle axis.
    print(f"refcount_update: share of entries whose new and old block agree "
          f"{(new == old).float().mean().item()!r}; mean run down the particle axis "
          f"{mean_run(new.view(n, mb))!r} (new), {mean_run(tables)!r} (old); distinct blocks "
          f"{int(torch.unique(new).numel())} (new), {int(torch.unique(old).numel())} (old)",
          flush=True)
    null_old = null_tables.reshape(-1).contiguous()
    null_new = null_tables[anc.clamp(max=n - 1)].reshape(-1).contiguous()
    exact(refcount_delta(null_new, null_old, nb, row=mb), refcount_delta_ref(null_new, null_old, nb),
          "refcount_update with NULL entries")
    new1, old1 = (new + 1).long(), (old + 1).long()
    report(
        "refcount_update", "src/repro/kernels/refcount_update/kernel.py:50",
        "src/repro_torch/csrc/refcount_update.cu", got, want,
        lambda: refcount_delta(new, old, nb, row=mb), lambda: refcount_delta_ref(new, old, nb),
        bytes_moved=2 * old.numel() * 4 + nb * 5,
        library_fn=lambda: torch.bincount(new1, minlength=nb + 1) - torch.bincount(old1, minlength=nb + 1),
    )
    del new, new1, old1, null_new, null_old, got, want

    # cow_gather: materialize_batch of all N over the LAZY run's pool.
    table = tables.reshape(-1).contiguous()
    got = cow_gather(pool.data, table)
    want = cow_gather_ref(pool.data, table)
    null_table = null_tables.reshape(-1).contiguous()
    exact([cow_gather(pool.data, null_table)], [cow_gather_ref(pool.data, null_table)],
          "cow_gather with NULL entries")
    distinct = int(torch.unique(table[table >= 0]).numel())
    flat_pool = pool.data.reshape(nb + 1, -1)
    safe_table = table.clamp(min=0).long()
    report(
        "cow_gather", "src/repro/kernels/cow_gather/kernel.py:35",
        "src/repro_torch/csrc/cow_gather.cu", [got], [want],
        lambda: cow_gather(pool.data, table), lambda: cow_gather_ref(pool.data, table),
        bytes_moved=table.numel() * 4 + distinct * 16 + table.numel() * 16,
        library_fn=lambda: torch.index_select(flat_pool, 0, safe_table),
    )
    del got, want, safe_table

    # clone_chain: the fused resample of the LAZY run's final weights and tables.
    u = torch.rand((), generator=gen, device=dev)
    exact(clone_chain_kernel(cum, u, null_tables, nb), clone_chain_ref(cum, u, null_tables, nb),
          "clone_chain with NULL entries")
    got = clone_chain_kernel(cum, u, tables, nb)
    want = clone_chain_ref(cum, u, tables, nb)
    # The kernel's premise: both tables repeat a block down the particle axis.
    print(f"clone_chain: share of entries whose new and old block agree "
          f"{(got[1] == tables).float().mean().item()!r}; mean run down the particle axis "
          f"{mean_run(got[1])!r} (new), {mean_run(tables)!r} (old)", flush=True)
    report(
        "clone_chain", "src/repro/kernels/clone_chain/kernel.py:96",
        "src/repro_torch/csrc/clone_chain.cu", got, want,
        lambda: clone_chain_kernel(cum, u, tables, nb), lambda: clone_chain_ref(cum, u, tables, nb),
        bytes_moved=n * 4 + 4 + 2 * tables.numel() * 4 + n * 4 + nb * 5,
        ops=n * (math.ceil(math.log2(n)) + 2),
    )
    final_logw = logw.clone()  # phase 2's final LAZY weights, for phase 11
    del got, want, results, lazy

    # -- 4. the card against the CPU path, same draws ---------------------
    small_n, small_t = 256, 32
    draws = [("normal", np.random.default_rng(1).standard_normal(small_n))]
    rng = np.random.default_rng(2)
    for t in range(small_t):
        if t:
            draws.append(("uniform", np.float32(rng.random())))
        draws.append(("normal", rng.standard_normal(small_n)))
    small = {}
    for where in ("cpu", "cuda"):
        cfg = FilterConfig(n_particles=small_n, n_steps=small_t, mode=CopyMode.LAZY_SR)
        pf = ParticleFilter(ssm, cfg, device=where)
        res = pf.run(rnd.Replay(draws, where), None, ys[:small_t])
        small[where] = (
            res.store.tables.cpu(), float(res.log_evidence),
            store_lib.materialize_batch(pf.store_cfg, res.store, torch.arange(small_n, device=where)).cpu(),
        )
    require(torch.equal(small["cpu"][0], small["cuda"][0]), "small run: tables equal on card and CPU")
    require(math.isclose(small["cpu"][1], small["cuda"][1], rel_tol=1e-5), "small run: log_evidence")
    require(torch.allclose(small["cpu"][2], small["cuda"][2], rtol=1e-5, atol=1e-6), "small run: trajectories")
    print(f"small run N={small_n} T={small_t}: card agrees with the CPU path "
          f"(log_evidence {small['cuda'][1]!r} vs {small['cpu'][1]!r})", flush=True)

    # -- 10. the store's delta COW at the filter's scale -------------------
    delta_row = delta_store_phase(dev, rate, ys)
    settle()

    # -- 11. the registry's other kernels at full width ---------------------
    registry_rows = registry_phase(dev, rate, final_logw)
    settle()

    # -- 6-9. serving starcoder2-3b at full width -------------------------
    rows += serve_phases(dev, rate)
    settle()

    # -- 12. SMC decoding through the scheduler at full width --------------
    smc = smc_decode_phase(dev, rows)
    settle()

    # -- 13. an SMC fleet of two replicas against one, and its replay -------
    fleet_phase(dev, rows, *smc)
    settle()

    # -- 17. the sharded store, on phase 12's weights for its decoder --------
    sharded_phase(dev, rate, rows, ys, *smc[:2])
    del smc
    settle()

    # -- 14. the paper's five programs at the paper's N and T (PCFG's cut) --
    programs_phase(dev, rows)
    settle()

    # -- 15. the moe and audio families at full width ---------------------
    family_phase(dev, rate, rows)
    settle()
    rows.insert(1, delta_row)
    rows[5:5] = registry_rows[:1]
    rows += registry_rows[1:]

    # -- 16. the dense-cache families at full width -------------------------
    dense_cache_phase(dev, rate, rows)
    settle()

    # -- 18. training: the backward kernels, Trainer, make_train_step -------
    train_phase(dev, rate, rows)
    settle()

    # -- 5. where a generation's time goes (a traced LAZY_SR run), last: a
    # trace of ~4e5 kernels costs later traces some of their records.
    prof_t = steps
    cfg = FilterConfig(n_particles=n, n_steps=prof_t, mode=CopyMode.LAZY_SR)
    pf = ParticleFilter(ssm, cfg, device=dev)
    torch.cuda.synchronize()
    before = dispatch.launch_counts()["cow_write"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pf.run(rnd.generator(SEED, dev), None, ys[:prof_t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traced = dispatch.launch_counts()["cow_write"] - before
    print(json.dumps({"profile": {
        "mode": "lazy_sr", "N": n, "T": prof_t,
        **profile_summary(prof, wall * 1e3, prof_t, "generation", "cow_write_kernel", traced),
    }}), flush=True)

    floor_ms = registry_rows[0]["launch_floor_ms"]
    for row in rows:
        if row["bound_ms"] < floor_ms:
            row["launch_floor_ms"] = floor_ms
    print(f"launch floor {floor_ms:.5f} ms; bounds below it: "
          f"{[row['name'] for row in rows if 'launch_floor_ms' in row]}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    # The one card this run used.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
