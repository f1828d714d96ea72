from repro_torch.kernels.cow_write.ops import cow_write, cow_write_delta
from repro_torch.kernels.cow_write.ref import cow_write_delta_ref, cow_write_ref
