from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_scan_bwd_ref, ssd_scan_ref
