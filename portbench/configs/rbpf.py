"""The paper's RBPF program, as the port ships it."""

from repro_torch.smc.filters import SSMDef
from repro_torch.smc.programs import rbpf


def build(config: dict) -> SSMDef:
    program = {"A": [list(r) for r in rbpf._A], "QZ": rbpf._QZ, "C": list(rbpf._C),
               "B": list(rbpf._B), "Q_XI": rbpf.Q_XI, "R_Y": rbpf.R_Y}
    stated = {k: config[k] for k in program}
    if stated != program:
        raise ValueError(f"the configuration states {stated}; the program runs {program}")
    return rbpf.build()[0]
