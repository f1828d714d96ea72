"""GOOD: consumed names rebound to the successor, or copied before.

Counterparts of the reference's ``use_after_donate/good_rebound.py``,
one function each, under the same names, and the port's own idioms: the
scheduler's cloned rollback snapshot, the engine's rebinding of
``self.cache``, a loop that threads the cache.
"""

import copy

import torch

from repro_torch import random as rnd
from repro_torch.serving import kv_cache as kvc
from repro_torch.smc import executor as executor_lib


def rebind(lm, params, tok, cache):
    logits, cache = lm.decode_step(params, tok, cache)  # successor takes the name
    return cache.position, logits


def read_before(lm, params, tok, cache):
    before = cache.position.clone()  # a copy taken before the call
    logits, cache = lm.decode_step(params, tok, cache)
    return before, cache


@torch.library.custom_op("torch_lint_corpus::twice", mutates_args=())
def twice(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def no_donation(buf, x):
    head = buf[0:4]
    out = twice(buf)  # mutates_args=(): nothing written in place
    return head.sum(), out


def computed_mutation(buf, x, op):
    head = buf[0:4]
    op(buf, x)  # an op built elsewhere: invisible, so never flagged
    return head.sum()


class Scheduler:
    def __init__(self, engine, gen):
        self.engine = engine
        self.gen = gen

    def snapshot(self):
        # the scheduler's idiom: every leaf cloned
        return {"cache": executor_lib.snapshot(self.engine.cache), "gen": rnd.snapshot(self.gen)}

    def step(self, lm, params, tok):
        snap = self.snapshot()
        logits, self.engine.cache = lm.decode_step(params, tok, self.engine.cache)
        if not bool(torch.isfinite(logits).all()):
            self.engine.cache = executor_lib.snapshot(snap["cache"])
        return logits


def engine_decode(self, cfg, tok, mask):
    cache, bid, pos = kvc.ensure_writable(cfg, self.cache, mask)
    self.cache = kvc.write_kv(cfg, cache, bid, pos, 0, tok, tok, mask)
    return self.cache


def threaded_loop(lm, params, toks, cache):
    for tok in toks:
        logits, cache = lm.decode_step(params, tok, cache)
    return cache


def deep_copied(lm, params, tok, cache):
    snap = copy.deepcopy(cache)
    logits, cache = lm.decode_step(params, tok, cache)
    return snap


def copied_to(x, y):
    keep = x.to(torch.float64, copy=True)
    x.add_(y)
    return keep


def rebound_alias(x, y):
    flat = x.view(-1)
    flat = flat.clone()  # rebinding ends the alias
    x.add_(y)
    return flat
