"""Mamba-2 SSD (state-space duality) chunked scan: the within-chunk terms
of every Mamba-2 layer's prefill."""
