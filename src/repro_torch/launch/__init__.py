"""Device meshes and the distributed aggregation step of the sharded HE
engine."""
