"""Process meshes over torch.distributed ranks."""
