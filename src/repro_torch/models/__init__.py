"""repro_torch.models — the model zoo's `ssm` family (Mamba-2) in
PyTorch; see `registry.py` for the entry points."""
