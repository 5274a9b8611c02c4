"""Rank functions of the port's data-parallel tests
(`tests/test_torch_parallel*.py`), run by
`darknet_tpu_torch.parallel.multihost.spawn`: module-level, so that the
spawned processes import them by name; torch and the port only (the
spawned ranks never import jax or darknet_tpu).  Each rank writes what
the test compares into `out_dir`."""

from __future__ import annotations

import os
import signal

import numpy as np
import torch


def _flat(prefix, tree) -> dict:
    return {f"{prefix}/{i}/{k}": np.asarray(v)
            for i, d in enumerate(tree) for k, v in d.items()}


def dp_steps(rank, out_dir, cases):
    """Each case: `steps` data-parallel steps of its cfg from `p0` (numpy,
    unfolded) on this rank's block of the global batch (x, y); writes
    `<name>_<rank>.npz` with the params, momentum, costs and metrics."""
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.nn import params as tparams
    from darknet_tpu_torch.parallel import make_dp_train_step, make_mesh
    from darknet_tpu_torch.parallel.multihost import process_batch_slice
    from darknet_tpu_torch.train.step import init_opt_state

    mesh = make_mesh(device="cpu")
    for c in cases:
        g = build_graph(c["cfg"], train=True)
        dt = torch.bfloat16 if c["bf16"] else None
        step = make_dp_train_step(g, mesh, accum=c["accum"], compute_dtype=dt,
                                  train_act_dtype=dt)
        p = tparams.train_params_to_torch(g, c["p0"], "cpu")
        o = init_opt_state(g, p)
        start, size = process_batch_slice(c["x"].shape[0])
        x = torch.from_numpy(c["x"][start:start + size])
        y = torch.from_numpy(c["y"][start:start + size])
        costs, losses, counts = [], [], []
        for _ in range(c["steps"]):
            p, o, cost, m = step(p, o, x, y, g.net.lr)
            costs.append(float(cost))
            losses.append(float(m["loss"]))
            counts.append(float(m["count"]))
        out = _flat("params", tparams.train_params_to_numpy(g, p))
        out.update(_flat("u", tparams.train_params_to_numpy(g, o["u"])))
        np.savez(os.path.join(out_dir, f"{c['name']}_{rank}.npz"),
                 costs=np.asarray(costs), losses=np.asarray(losses),
                 counts=np.asarray(counts), t=o["t"], **out)


def train_ranks(rank, out_dir, kw, max_iters, stop_at=None):
    """A DetectorTrainer on this rank's block (kw: its arguments but the
    mesh), for max_iters; where stop_at = (rank, iteration), that rank
    signals itself SIGTERM once it has begun that iteration.  Writes
    `train_<rank>.npz`: the params, seen, the in-training mAPs and what
    each iteration's loader batch held."""
    from darknet_tpu_torch.nn import params as tparams
    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.train.trainer import DetectorTrainer

    tr = DetectorTrainer(mesh=make_mesh(device="cpu"), device="cpu", **kw)
    batches = []
    nxt = tr.loader.next

    def spy_next():
        x, y = nxt()
        batches.append((np.asarray(x), np.asarray(y)))
        if stop_at is not None and stop_at[0] == rank and \
                tr.curr_iter == stop_at[1]:
            os.kill(os.getpid(), signal.SIGTERM)
        return x, y

    tr.loader.next = spy_next
    try:
        tr.train(max_iters=max_iters)
    finally:
        tr.close()
    out = _flat("params", tparams.train_params_to_numpy(tr.graph, tr.params))
    np.savez(os.path.join(out_dir, f"train_{rank}.npz"), seen=tr.seen,
             best_map=tr._best_map, maps=np.asarray(tr._chart["maps"]),
             x=np.stack([b[0] for b in batches]),
             y=np.stack([b[1] for b in batches]), **out)


def validate_ranks(rank, out_dir, cfg, weights, paths, classes, batch):
    """validate_detector over a mesh that spans the processes; writes
    `map_<rank>.npz` with the MapResult's numbers."""
    from darknet_tpu_torch.eval.map import validate_detector
    from darknet_tpu_torch.nn.network import Network
    from darknet_tpu_torch.parallel import make_mesh

    net = Network.from_cfg(cfg, weights=weights, device="cpu")
    res = validate_detector(net, paths, classes, batch=batch,
                            progress=False, resize="darknet",
                            mesh=make_mesh(device="cpu"))
    np.savez(os.path.join(out_dir, f"map_{rank}.npz"), map=res.map,
             ap=res.per_class_ap, n_pred=res.n_pred, n_gt=res.n_gt,
             recall=res.recall, precision=res.precision)


def checkpoint_ranks(rank, out_dir, state):
    """save_checkpoint_sharded of `state` by every rank, then a load."""
    from darknet_tpu_torch.train import checkpoint as ck

    params, opt, seen, rng, extra = state
    path = os.path.join(out_dir, "state")
    ck.save_checkpoint_sharded(path, params, opt, seen=seen, rng_key=rng,
                               extra=extra)
    got = ck.load_checkpoint_sharded(path, params, opt)
    np.savez(os.path.join(out_dir, f"ck_{rank}.npz"), seen=got[2],
             rng=got[3], files=np.asarray(sorted(os.listdir(path))),
             **_flat("params", got[0]), **_flat("u", got[1]["u"]),
             **{f"extra/{k}": v for k, v in got[4].items()})


def int8_mesh_ranks(rank, out_dir, cfg, weights, x):
    """Dynamic int8 serving of the whole batch `x` over the world's dp
    mesh (one block a rank): writes `int8_<rank>.npz` with each int8
    conv's scale, whether it is the scale of the group's max|x| (taken
    here with an all_reduce of this rank's own), and the gathered heads."""
    import torch.distributed as dist

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.parallel import make_mesh

    net = Network.from_cfg(cfg, weights=weights, device="cpu", int8=True)
    mesh = make_mesh(device="cpu")
    orig, scales, ok = convmod.conv2d_int8, [], []

    def spy(xb, p, **kw):
        m = xb.float().abs().amax().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        m = torch.clamp_min(m, 1e-8)
        scale = torch.as_tensor(
            p["x_scale"] if "x_scale" in p
            else convmod.input_scale(xb.float())).reshape(())
        scales.append(float(scale))
        ok.append(bool(torch.equal(scale, convmod.input_scale(m, absmax=m))))
        return orig(xb, p, **kw)

    convmod.conv2d_int8 = spy
    try:
        with torch.inference_mode():
            heads = net._over_mesh(mesh, torch.from_numpy(x),
                                   lambda p, u, xs, h: tuple(h))
    finally:
        convmod.conv2d_int8 = orig
    np.savez(os.path.join(out_dir, f"int8_{rank}.npz"),
             scales=np.asarray(scales, np.float32), ok=np.asarray(ok),
             **{f"head{k}": h.float().numpy() for k, h in enumerate(heads)})
