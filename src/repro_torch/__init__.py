"""repro_torch — the PyTorch / CUDA port of the WANify reproduction.

A second package beside the JAX reference `repro`, with the same
module layout: `repro_torch/wan/simulator.py` is the port of
`repro/wan/simulator.py`. It imports torch and numpy, never jax and
never `repro`. The control plane stays host numpy float64 (bit-equal
to the reference); the forest inference of the fleet tick is a CUDA
kernel written for Hopper (`csrc/rf_predict.cu`). Entry points that
touch the device run on CUDA unless the caller passes ``device="cpu"``.
"""
