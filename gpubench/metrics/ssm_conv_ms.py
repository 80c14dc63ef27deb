"""ssm_conv_ms: device milliseconds a step of the operations under the
Mamba-2 mixer's spans ``ssm.conv`` and ``ssm.conv.bwd``
(``models/ssm.py``: the three causal depthwise convolutions and their
silu) in the forward, the recompute and the backward, counted as
``ssm_proj_ms`` counts."""
from gpubench import bench


def read(ctx):
    return bench.metric_reader("ssm_proj_ms").part_ms(ctx["trace"],
                                                      "ssm.conv")
