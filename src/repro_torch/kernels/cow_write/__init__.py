from repro_torch.kernels.cow_write.ops import cow_write
from repro_torch.kernels.cow_write.ref import cow_write_ref
