"""softgroup_tpu_torch — the PyTorch/CUDA port of softgroup_tpu for NVIDIA
Hopper (H100).

The JAX package ``softgroup_tpu`` is the reference this package is held
against; this package imports nothing of it (nor JAX).  Every Pallas TPU
kernel on the ported path is a hand-written CUDA kernel under ``csrc/``,
built with nvcc for sm_90a at first use (``ops/kernels.py``).  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU; on
CPU tensors each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
