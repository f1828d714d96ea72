from repro_torch.kernels.refcount_update.ops import refcount_delta, refcount_update
from repro_torch.kernels.refcount_update.ref import refcount_delta_ref
