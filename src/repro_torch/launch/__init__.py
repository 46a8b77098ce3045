"""Device meshes (model meshes over torch.distributed and the sharded HE
engine's), the train/prefill/decode steps and their placed `jit_*` forms,
the distributed aggregation step, the drivers, and the multi-pod
dry-run."""
