"""Device-mesh parallelism for the policy engine.

Port of istio_tpu/parallel/. SPMD over a mesh of (virtual) devices
(platform.py):

  axis "dp"  — data parallel over the request batch (rule tensors
               replicate).
  axis "mp"  — model parallel over RULES: each shard matches its rows
               against its rule slice end to end, and the only
               cross-shard work on the request path is the verdict
               fold's reduction over "mp" (the mesh_fold kernel).

seq_match.py shards a long subject's byte axis over a mesh axis and
matches one DFA with one gather of per-shard transition maps.
"""
from istio_tpu_torch.parallel.mesh import (MeshSpec, policy_mesh, shard_batch,
                                           shard_engine_check)

__all__ = ["MeshSpec", "policy_mesh", "shard_batch", "shard_engine_check"]
