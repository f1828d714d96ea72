from repro_torch.kernels.clone_chain.ops import clone_chain, clone_chain_kernel
from repro_torch.kernels.clone_chain.ref import (
    clone_chain_ref,
    comb_positions,
    fixed_order_cumsum,
    weights_cdf,
)
