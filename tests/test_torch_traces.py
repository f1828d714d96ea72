"""The port's seeded arrival traces, against the JAX reference's.

``repro_torch.serving.traces`` is the port's own copy of the reference's
numpy-only module: for the same arguments every generator, and
``with_deadlines`` and ``with_synthetic_forks`` on top, must give
``to_json`` output byte-equal to the reference's, and each package's
``from_json`` must read the other's.  ``to_decode_requests`` lowers to the
port's ``DecodeRequest``: prompts from ``torch.randint`` on a generator
seeded with the request's seed, generators seeded with ``key_base + seed``,
on an explicit device (the reference's threefry prompts do not carry
over).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.serving import traces as jtraces  # noqa: E402
from repro_torch.serving import traces as ttraces  # noqa: E402
from repro_torch.serving.scheduler import DecodeRequest  # noqa: E402

SIZES = dict(n_particles=(2, 6), steps=(4, 16), plen=(2, 12))
FIXED = dict(n_particles=4, steps=6, plen=5)

GENERATORS = {
    "staggered": lambda lib, seed, sizes: lib.staggered(5, 3, seed=seed, **sizes),
    "burst": lambda lib, seed, sizes: lib.staggered(4, 0, seed=seed, **sizes),
    "poisson": lambda lib, seed, sizes: lib.poisson(25, 0.4, seed=seed, **sizes),
    "bursty": lambda lib, seed, sizes: lib.bursty(3, 4, 10, seed=seed, **sizes),
    "diurnal": lambda lib, seed, sizes: lib.diurnal(30, 100, 1.0, 0.1, seed=seed, **sizes),
}


def both(name, seed, sizes):
    return GENERATORS[name](jtraces, seed, sizes), GENERATORS[name](ttraces, seed, sizes)


@pytest.mark.parametrize("sizes", [SIZES, FIXED], ids=["ranged", "fixed"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_byte_equal_to_reference(name, sizes):
    """Each generator over seeds, then deadlines (every third tight) and
    synthetic forks on top: the same JSON bytes as the reference's, and
    each package's ``from_json`` reads the other's output back to its own
    trace."""
    for seed in (0, 1, 13, 2**31 - 1):
        jt, tt = both(name, seed, sizes)
        stages = [(jt, tt)]
        stages.append((jtraces.with_deadlines(jt, tight_every=3),
                       ttraces.with_deadlines(tt, tight_every=3)))
        stages.append((jtraces.with_synthetic_forks(stages[-1][0], 0.5),
                       ttraces.with_synthetic_forks(stages[-1][1], 0.5)))
        for j, t in stages:
            text = ttraces.to_json(t)
            assert text == jtraces.to_json(j), (name, seed)
            assert ttraces.from_json(jtraces.to_json(j)) == t
            assert jtraces.from_json(text) == j
        assert tt.total_tokens == jt.total_tokens


@settings(derandomize=True, database=None, max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), rate=st.floats(0.01, 5.0), p=st.floats(0.0, 1.0),
       slack=st.floats(1.0, 3.0), floor=st.integers(0, 8))
def test_poisson_with_forks_and_deadlines_byte_equal(seed, rate, p, slack, floor):
    def make(lib):
        t = lib.poisson(12, rate, seed=seed, **SIZES)
        return lib.with_synthetic_forks(lib.with_deadlines(t, slack, floor), p)

    assert ttraces.to_json(make(ttraces)) == jtraces.to_json(make(jtraces))


def test_from_json_reads_traces_without_deadlines():
    """Traces written before deadlines existed load with ``deadline=None``,
    as the reference's do."""
    import json

    payload = json.loads(jtraces.to_json(jtraces.staggered(2, 1, seed=3, **FIXED)))
    for r in payload["requests"]:
        del r["deadline"]
    back = ttraces.from_json(json.dumps(payload))
    assert back == ttraces.staggered(2, 1, seed=3, **FIXED)


def test_to_decode_requests_on_the_cpu():
    trace = ttraces.with_deadlines(ttraces.staggered(3, 2, seed=4, **FIXED))
    reqs = ttraces.to_decode_requests(trace, 101, target_temp=0.7, token_block_size=4,
                                      device="cpu")
    for r, tr in zip(reqs, trace.requests, strict=True):
        assert isinstance(r, DecodeRequest)
        assert (r.rid, r.arrive_at, r.deadline, r.n_particles, r.steps) == (
            tr.rid, tr.arrive_at, tr.deadline, tr.n_particles, tr.steps)
        assert (r.target_temp, r.token_block_size) == (0.7, 4)
        want = torch.randint(0, 101, (tr.plen,), generator=torch.Generator().manual_seed(tr.seed))
        assert r.prompt.device.type == "cpu" and torch.equal(r.prompt, want)
        gen = torch.Generator().manual_seed(1000 + tr.seed)
        assert torch.equal(r.gen.get_state(), gen.get_state())
    again = ttraces.to_decode_requests(trace, 101, key_base=7, device="cpu")
    assert torch.equal(again[0].gen.get_state(),
                       torch.Generator().manual_seed(7 + trace.requests[0].seed).get_state())


def test_to_decode_requests_defaults_to_the_card():
    trace = ttraces.staggered(1, 0, **FIXED)
    if torch.cuda.is_available():
        (r,) = ttraces.to_decode_requests(trace, 101)
        assert r.prompt.is_cuda and r.gen.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttraces.to_decode_requests(trace, 101)
