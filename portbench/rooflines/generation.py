"""A whole filter generation, as any implementation must do it.

Per particle: its state read and written once, its log-weight written
and read, its ancestor index written and read, its record appended, and
the model step's arithmetic (``step_flops``, counted from the
configuration's formula).  Block tables, refcounts and pool bookkeeping
are not counted: another storage scheme would need none of them.
"""


def least_bytes(n: int, state_floats: int, record_elems: int) -> int:
    return n * (2 * 4 * state_floats + 2 * 4 + 2 * 4 + 4 * record_elems)


def least_seconds(config: dict, peaks: dict) -> float:
    n = config["n_particles"]
    data = least_bytes(n, config["state_floats"], config["record_elems"]) / peaks["hbm_bytes_per_s"]
    math = n * config["step_flops"] / peaks["f32_flops_per_s"]
    return max(data, math)
