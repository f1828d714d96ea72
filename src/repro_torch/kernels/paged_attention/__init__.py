from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_attention_delta_kernel,
    paged_attention_kernel,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
