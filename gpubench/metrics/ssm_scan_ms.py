"""ssm_scan_ms: device milliseconds a step of the operations under the
Mamba-2 mixer's spans ``ssm.scan`` and ``ssm.scan.bwd``
(``models/ssm.py``: the SSD, its kernels forward and backward and the
plain combine around them) in the forward, the recompute and the
backward, counted as ``ssm_proj_ms`` counts."""
from gpubench import bench


def read(ctx):
    return bench.metric_reader("ssm_proj_ms").part_ms(ctx["trace"],
                                                      "ssm.scan")
