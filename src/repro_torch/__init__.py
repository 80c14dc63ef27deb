"""repro_torch: the HDOT system ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference (``repro``), module for module:
processes are ``torch.distributed`` ranks, halo messages are point-to-point
sends, and each Pallas TPU kernel on a ported path is a CUDA kernel written
by hand for ``sm_90a`` with a plain PyTorch version beside it.

Public API (lazy — importing ``repro_torch`` touches no device):
    repro_torch.checkpoint -- atomic, async checkpoints (the JAX layout)
    repro_torch.config   -- model, parallel, train configs; --arch registry
    repro_torch.core     -- domain / cost / halo / reduction / stencil /
                            overlap (the gradient buckets)
    repro_torch.data     -- the synthetic LM data pipeline
    repro_torch.kernels  -- hand-written Hopper kernels (+ plain versions)
    repro_torch.launch   -- process meshes; the train step; the serving
                            and training launchers
    repro_torch.models   -- language models (dense GQA, Mamba-2,
                            RecurrentGemma), the fused cross-entropy
    repro_torch.optim    -- AdamW, the schedule, narrow-wire codecs
    repro_torch.runtime  -- the re-cut loop, the straggler drill; the
                            batched server; the data-parallel trainer
"""

__version__ = "0.1.0"

__all__ = ["checkpoint", "config", "core", "data", "kernels", "launch",
           "models", "optim", "runtime", "__version__"]


def __getattr__(name):
    if name in __all__:
        import importlib

        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
