"""Multi-device layer: process groups and device meshes (mesh.py), and the
sharded stereo pipeline (shard.py), on torch.distributed."""
