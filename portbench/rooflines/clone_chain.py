"""The fused resample -> clone kernel (``clone_chain_kernel``) at one
generation.

Counted once each: the weights' CDF read (4 B a particle), the ancestors
written (4 B), and each particle's live table entries, ``ceil(t / B)``
int32 ids after ``t`` appends at block size ``B``, read from the old
tables (all of them: every old reference is released) and written to
the new.  Not counted: the refcount delta and the membership bits,
which the kernel writes sparsely into arrays zeroed apart from it, and
the tables' unset (NULL) tail.  No floating-point operations are
counted: the comb search compares.
"""


def least_bytes(n: int, live_blocks: int) -> int:
    return 4 * n + 4 * n + 2 * 4 * n * live_blocks


def least_seconds(config: dict, t: int, peaks: dict) -> float:
    """The least time of the clone that starts generation ``t``."""
    n, bs = config["n_particles"], config["filter"]["block_size"]
    return least_bytes(n, -(-t // bs)) / peaks["hbm_bytes_per_s"]
