"""Runtime drivers: the measured-cost re-cut loop around the Heat2D solver."""
