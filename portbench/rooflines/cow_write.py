"""The copy-on-write append kernel (``cow_write_kernel``) at one
generation: every particle appends one record.

Counted once each: the destination block and slot of each particle
(4 + 4 B), its record read, and the record written into the pool.  Not
counted: the source ids and the payload that a copy of a shared block
moves (which particles copy depends on the ancestry), nor the pool's
bookkeeping, which other launches do.
"""


def least_bytes(n: int, record_bytes: int) -> int:
    return n * (8 + 2 * record_bytes)


def least_seconds(config: dict, peaks: dict) -> float:
    n = config["n_particles"]
    return least_bytes(n, 4 * config["record_elems"]) / peaks["hbm_bytes_per_s"]
