"""Periodic weight-averaging data parallelism, the reference-compatibility
mode (`darknet_tpu/parallel/weight_avg.py`) on torch.

The reference's multi-GPU training (`network_kernels.cu:295-484`) runs one
independent replica a device and every `sync_interval` (=4,
detector.cpp:196) iterations averages the WEIGHTS across replicas through
host memory; gradients are never exchanged and LR is pre-multiplied by the
replica count (detector.cpp:67).

The port's default data parallelism is the per-step gradient sum
(`parallel/dp.py`), strictly stronger.  This mode reproduces the
reference's semantics for A/B comparisons: replicas are a list, each steps
on its own shard with its own momentum (a loop over the replicas where the
JAX package vmaps a stacked axis), and `sync()` averages the parameters
(rolling statistics included, as the JAX package's tree mean does); the
momenta stay per replica, as SyncNetworks touches only the weights.
"""

from __future__ import annotations

import torch

from darknet_tpu_torch.train.step import make_train_step


def replicate_params(params, n_replicas: int) -> list:
    """n independent copies of one replica's params."""
    return [[{k: v.detach().clone().requires_grad_(v.requires_grad)
              for k, v in p.items()} for p in params]
            for _ in range(n_replicas)]


def make_weight_avg_train_step(graph, n_replicas: int, *,
                               compute_dtype=None):
    """Returns (step, sync):

    step(params_r, opt_r, x_r, truths_r, lr, generator=None) -> (params_r,
    opt_r, costs (n,), metrics list): x_r / truths_r carry a leading
    replica axis (each replica its own shard, the GetPartialData split);
    every replica steps independently, in place.
    sync(params_r) -> params_r: SyncNetworks, every param the mean of the
    replicas', written into each replica."""
    inner = make_train_step(graph, compute_dtype=compute_dtype)

    def step(params_r, opt_r, x_r, truths_r, lr, generator=None):
        if not len(params_r) == len(opt_r) == x_r.shape[0] == n_replicas:
            raise ValueError(f"{n_replicas} replicas: got {len(params_r)} "
                             f"params, {len(opt_r)} optimizer states and "
                             f"{x_r.shape[0]} shards")
        costs, metrics = [], []
        for i in range(n_replicas):
            params_r[i], opt_r[i], c, m = inner(params_r[i], opt_r[i],
                                                x_r[i], truths_r[i], lr,
                                                generator)
            costs.append(c)
            metrics.append(m)
        return params_r, opt_r, torch.stack(costs), metrics

    @torch.no_grad()
    def sync(params_r):
        for layer in zip(*params_r):
            for k in layer[0]:
                mean = torch.stack([p[k] for p in layer]).mean(0)
                for p in layer:
                    p[k].copy_(mean)
        return params_r

    return step, sync
