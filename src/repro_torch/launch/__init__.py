"""Process meshes over torch.distributed ranks, and the serving launcher."""
