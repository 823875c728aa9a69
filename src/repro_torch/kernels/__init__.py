"""Hand-written CUDA kernels for Hopper (sources in `repro_torch/csrc/`),
their plain PyTorch versions in `ref.py`; call through `ops.py`."""
