"""Scale-out over torch.distributed (the port of hiprfish_tpu/parallel/):
the ('fov', 'tile') DeviceMesh and its collectives (mesh.py), the
environment contract and the per-rank runner (distributed.py), LP-CV over
row shards with halo exchange (spatial.py), and FOV batches over the mesh
with the out-of-memory halving and data-parallel training
(fov_batch.py)."""
