"""Parallelism on torch (`darknet_tpu/parallel`): meshes, the
data-parallel step, processes of a world and weight averaging; and
model-parallel serving in one process over a mesh's devices: feature
maps split over `sp` (`spatial`), conv filters over `tp` (`tensor`) and
layer stages (`pipeline`).  Model-parallel training is ROADMAP A7c."""

from darknet_tpu_torch.parallel.dp import make_dp_train_step
from darknet_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate", "make_dp_train_step"]
