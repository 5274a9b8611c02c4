"""Data-parallel training step (`darknet_tpu/parallel/dp.py`) on torch.

Each rank of the mesh's process group calls the step with its own
contiguous block of the global batch, `parallel/multihost.
process_batch_slice`, and the step equals `train/step.make_train_step` on
the global batch: sync-BN statistics over the group, one gradient sum a
step after the micro-batches, the cost and the metrics over the group
(the group's part of `train/step`).  It subsumes the reference's
TrainNetworks / SyncNetworks (`network_kernels.cu:295-484`) with exact
per-step synchronisation; no DDP wrapper is needed, since the params are
a list of dicts of tensors, not a module.

Subdivisions: the JAX step's micro-batch j is x[j::accum] of the global
batch, sharded over dp.  Since each micro-batch divides over the ranks,
rank r's share of micro-batch j is its block's [j::accum], which is what
the step takes from the block it is given.

On LR: the reference multiplies LR by the GPU count and keeps the
per-replica batch (`detector.cpp:67`).  Here `[net] batch` is the global
batch; to scale as the reference does when the mesh grows, scale the cfg's
LR the same way (documented, not implicit).
"""

from __future__ import annotations

from darknet_tpu_torch.train.step import make_train_step


def make_dp_train_step(graph, mesh, *, axis: str = "dp", compute_dtype=None,
                       accum: int = 1, remat: bool = False,
                       train_act_dtype=None):
    """The step of one rank, `step(params, opt_state, x, truths, lr,
    generator=None)` on this rank's block (`train/step.make_train_step`).
    A mesh of several devices must span processes (one a device): a mesh
    of one process's devices has no group to sum over and raises.  On a
    grid of several axes over the world (`parallel/mesh.world_mesh`) the
    statistics and the gradient sum run over the `axis` line through
    this rank only: the ranks on the other axes hold other replicas."""
    n_dp = mesh.shape[axis]
    if n_dp > 1 and mesh.group is None:
        raise ValueError(
            f"a data-parallel step runs one process a device: {mesh} spans "
            f"one process (make the mesh under torch.distributed, e.g. "
            f"through parallel.multihost.spawn)")
    # each micro-batch must divide over the ranks, or the ranks' shares of
    # a micro-batch would differ in size
    b = graph.net.optimizer_batch
    accum = max(accum, 1)
    if b % accum == 0 and (b // accum) % n_dp:
        raise ValueError(
            f"micro-batch {b // accum} (= batch {b} / subdivisions {accum}) "
            f"must divide evenly across the {n_dp}-device '{axis}' axis")
    group = mesh.sub(axis) if mesh.spans_world else mesh.group
    return make_train_step(graph, compute_dtype=compute_dtype, accum=accum,
                           remat=remat, train_act_dtype=train_act_dtype,
                           group=group)
