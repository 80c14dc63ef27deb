"""Runtime drivers: the measured-cost re-cut loop around the Heat2D solver,
and the batched server (wave and continuous batching)."""
