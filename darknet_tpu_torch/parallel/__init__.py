"""Data parallelism on torch (`darknet_tpu/parallel`): meshes, the
data-parallel step, processes of a world and weight averaging.  The
model-parallel modules (spatial, tensor, pipeline) are ROADMAP A7b."""

from darknet_tpu_torch.parallel.dp import make_dp_train_step
from darknet_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate", "make_dp_train_step"]
