"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel package provides:
  csrc/*.cu -- the CUDA C++ kernel for sm_90a with a plain C interface
  ops.py    -- the wrapper: validates, dispatches (kernel for a CUDA tensor,
               plain version for a CPU tensor) and counts launches
  ref.py    -- the plain PyTorch version (the CPU path and the card oracle)

Kernels are built by nvcc at first use (:mod:`repro_torch.kernels._build`).
"""


def needs_grad(*tensors) -> bool:
    """Whether autograd wants a gradient of any of `tensors` (None
    allowed): the wrappers go through their ``torch.autograd.Function``
    only then, since ``Function.apply`` alone costs ~0.07 ms of host time,
    more than a short scan kernel takes on the card."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
