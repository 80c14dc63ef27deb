"""ssm_gate_norm_ms: device milliseconds a step of the operations under
the Mamba-2 mixer's spans ``ssm.gate_norm`` and ``ssm.gate_norm.bwd``
(``models/ssm.py``: the D skip, the gate by silu(z) and the float32
norm) in the forward, the recompute and the backward, counted as
``ssm_proj_ms`` counts."""
from gpubench import bench


def read(ctx):
    return bench.metric_reader("ssm_proj_ms").part_ms(ctx["trace"],
                                                      "ssm.gate_norm")
