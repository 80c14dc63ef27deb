"""Optimizer-side pieces of the port: the narrow-wire gradient codecs."""
