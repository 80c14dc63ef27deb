"""Runtime drivers: the measured-cost re-cut loop around the Heat2D solver,
the live straggler drill and its host-shard reassignment, the batched
server (wave and continuous batching) and the data-parallel trainer."""
