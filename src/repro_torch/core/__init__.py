"""HDOT core on PyTorch.

- :mod:`repro_torch.core.domain`     hierarchical domain over-decomposition
- :mod:`repro_torch.core.cost`       measured-cost model for re-cuts
- :mod:`repro_torch.core.halo`       halo exchange with interior/boundary overlap
- :mod:`repro_torch.core.reduction`  hierarchical task->process reductions
- :mod:`repro_torch.core.stencil`    Heat2D, RK3 and HPCCG on the core
- :mod:`repro_torch.core.overlap`    gradient buckets: two-phase vs HDOT sync
- :mod:`repro_torch.core.a2a_scan`   the HDOT-chunked all-to-all of expert
  parallelism
"""
