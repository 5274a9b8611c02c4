"""Parallelism on torch (`darknet_tpu/parallel`): meshes, the
data-parallel step, processes of a world and weight averaging; and
model-parallel serving and training: feature maps split over `sp`
(`spatial`), conv filters over `tp` (`tensor`, with `sp` the (dp, sp, tp)
step) and layer stages (`pipeline`, GPipe training in `PipelineTrain`),
each in one process that drives a mesh's devices or over a grid that
spans the world, one process a device (`mesh.world_mesh`, exchanging
through `ops/collective`)."""

from darknet_tpu_torch.parallel.dp import make_dp_train_step
from darknet_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate", "make_dp_train_step"]
