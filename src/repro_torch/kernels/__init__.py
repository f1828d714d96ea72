"""Hand-written CUDA kernels for the COW platform, each beside its plain
PyTorch version (``<op>/ref.py``) and its wrapper (``<op>/ops.py``);
see :mod:`repro_torch.kernels.dispatch` for the device policy."""
