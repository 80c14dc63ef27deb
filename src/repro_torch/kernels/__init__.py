"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel package provides:
  csrc/*.cu -- the CUDA C++ kernel for sm_90a with a plain C interface
  ops.py    -- the wrapper: validates, dispatches (kernel for a CUDA tensor,
               plain version for a CPU tensor) and counts launches
  ref.py    -- the plain PyTorch version (the CPU path and the card oracle)

Kernels are built by nvcc at first use (:mod:`repro_torch.kernels._build`).
"""
