"""repro_torch: the HDOT system ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference (``repro``), module for module:
processes are ``torch.distributed`` ranks, halo messages are point-to-point
sends, and each Pallas TPU kernel on a ported path is a CUDA kernel written
by hand for ``sm_90a`` with a plain PyTorch version beside it.

Public API (lazy — importing ``repro_torch`` touches no device):
    repro_torch.config   -- model configs and the --arch registry
    repro_torch.core     -- domain / cost / halo / reduction / stencil
    repro_torch.kernels  -- hand-written Hopper kernels (+ plain versions)
    repro_torch.launch   -- process meshes; the serving launcher
    repro_torch.models   -- dense GQA language models
    repro_torch.optim    -- narrow-wire gradient codecs
    repro_torch.runtime  -- the re-cut loop, the straggler drill; the
                            batched server
"""

__version__ = "0.1.0"

__all__ = ["config", "core", "kernels", "launch", "models", "optim",
           "runtime", "__version__"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
