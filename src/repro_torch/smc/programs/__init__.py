# The paper's five evaluation problems (Section 4), as vectorized PyTorch
# probabilistic programs over the lazy-copy store (the port of
# repro.smc.programs):
#
#   RBPF — mixed linear/nonlinear SSM, Rao-Blackwellized PF
#   PCFG — probabilistic context-free grammar, auxiliary PF, stack state
#   VBD  — vector-borne disease (SEIR/SEI), particle Gibbs (eager ref copy)
#   MOT  — multi-object tracking, unknown object count (ragged arrays)
#   CRBD — constant-rate birth-death, alive particle filter
#
# Each module exposes: NAME, METHOD, PAPER_N, PAPER_T, build(), gen_data(gen, t).

from repro_torch.smc.programs import crbd, mot, pcfg, rbpf, vbd

PROBLEMS = {m.NAME: m for m in (rbpf, pcfg, vbd, mot, crbd)}

__all__ = ["PROBLEMS", "rbpf", "pcfg", "vbd", "mot", "crbd"]
