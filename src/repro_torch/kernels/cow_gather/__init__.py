from repro_torch.kernels.cow_gather.ops import cow_gather, pool_compact
from repro_torch.kernels.cow_gather.ref import cow_gather_ref
