"""Process meshes over torch.distributed ranks, the data-parallel train
step, and the serving and training launchers."""
