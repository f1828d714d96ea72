from repro_torch.kernels.resample.ops import resample_systematic_kernel, systematic_comb
from repro_torch.kernels.resample.ref import PLANTED, planted_cdfs, resample_systematic_ref
