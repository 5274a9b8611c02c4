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


# ------------------------------------------------ model-parallel meshes
def _case_mesh(c):
    """The case's grid over its ranks of the world (None on the others):
    every rank calls it for every case, in order."""
    from darknet_tpu_torch.parallel.mesh import world_mesh

    return world_mesh(c["shape"], device="cpu", ranks=c["ranks"])


def _serve_net(c):
    """The case's Network: f32, bf16, or int8 (dynamic, or calibrated on
    c["calib"])."""
    import warnings

    from darknet_tpu_torch import Network

    kw = {"bf16": dict(compute_dtype=torch.bfloat16),
          "int8": dict(int8=True), "int8cal": dict(int8=True)}.get(
              c["dtype"], {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(c["cfg"], weights=c["weights"], device="cpu",
                               **kw)
    if c["dtype"] == "int8cal":
        net.calibrate_int8([f for f in c["calib"]])
    return net


def _heads_np(prefix, heads) -> dict:
    return {f"{prefix}{k}": h.float().numpy() for k, h in enumerate(heads)}


def mp_serve_ranks(rank, out_dir, cases):
    """Each case served over its world grid and over the one-process mesh
    of the same shape, in this rank (tests/test_torch_mp_serve.py):
    writes `<name>_<rank>.npz` with both ("got*", "want*"), the rows of
    this rank's part of the batch, and for the Network's sp cases the
    served triple both ways."""
    from darknet_tpu_torch.parallel.pipeline import PipelineForward
    from darknet_tpu_torch.parallel.spatial import make_spatial_mesh
    from darknet_tpu_torch.parallel.tensor import (make_tp_forward,
                                                   make_tp_mesh)

    torch.set_num_threads(1)
    for c in cases:
        mesh = _case_mesh(c)
        if mesh is None:
            continue
        net = _serve_net(c)
        g, x = net.graph, torch.from_numpy(c["x"])
        shape, out = c["shape"], {}
        n_dp = shape.get("dp", 1)
        per = x.shape[0] // n_dp
        b = mesh.coords.get("dp", 0)
        lo, hi = b * per, (b + 1) * per
        if c["kind"] == "sp":
            one = make_spatial_mesh(n_dp, shape["sp"], device="cpu")
            with torch.inference_mode():
                got = net._over_mesh(mesh, x[lo:hi],
                                     lambda p, u, xs, h: tuple(h))
                want = [h[lo:hi] for h in net._over_mesh(
                    one, x, lambda p, u, xs, h: tuple(h))]
            if c.get("triple"):
                tg = net.submit_detect_device(x[lo:hi], thresh=0.1,
                                              mesh=mesh)
                tw = net.submit_detect_device(x, thresh=0.1, mesh=one)
                out.update({f"tgot{k}": t.numpy() for k, t in enumerate(tg)})
                out.update({f"twant{k}": t[lo:hi].numpy()
                            for k, t in enumerate(tw)})
        elif c["kind"] == "tp":
            lo, hi = 0, x.shape[0]
            cd = net.compute_dtype
            got = make_tp_forward(g, mesh, compute_dtype=cd,
                                  decode=False)(net.params, x)
            want = make_tp_forward(g, make_tp_mesh(n_dp, shape["tp"],
                                                   device="cpu"),
                                   compute_dtype=cd, decode=False)(
                net.params, x)
        else:
            lo, hi = 0, x.shape[0]
            n = shape["pp"]
            kw = dict(compute_dtype=net.compute_dtype,
                      microbatches=c["mb"])
            got = PipelineForward(g, net.params, mesh=mesh, **kw)(x)
            want = PipelineForward(g, net.params, ["cpu"] * n, **kw)(x)
            if got is None:
                got = want = []
        np.savez(os.path.join(out_dir, f"{c['name']}_{rank}.npz"),
                 rows=np.asarray([lo, hi]), **_heads_np("got", got),
                 **_heads_np("want", want), **out)


def _train_case(c):
    import warnings

    from darknet_tpu_torch.graph.builder import build_graph

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(c["cfg"], train=True)


def _step_once(c, g, mesh):
    """(params, cost, metrics, the generator's state after the step or
    None) of one step of the case over `mesh`, a world grid, or (None)
    the one-process mesh of the same shape; the params whole.  A case
    with "gen" steps with a generator of that seed."""
    from darknet_tpu_torch.nn import params as tparams
    from darknet_tpu_torch.parallel.mesh import grid_mesh
    from darknet_tpu_torch.parallel import tensor as ttensor
    from darknet_tpu_torch.parallel.pipeline import PipelineTrain
    from darknet_tpu_torch.parallel.spatial import make_spatial_train_step
    from darknet_tpu_torch.train.step import init_opt_state

    dt = torch.bfloat16 if c.get("bf16") else None
    kw = dict(accum=c["accum"], compute_dtype=dt, train_act_dtype=dt)
    x, y = torch.from_numpy(c["x"]), torch.from_numpy(c["y"])
    p = tparams.train_params_to_torch(g, c["p0"], "cpu")
    o = init_opt_state(g, p)
    gen = None if c.get("gen") is None else \
        torch.Generator().manual_seed(c["gen"])
    if c["kind"] == "pipe":
        pt = PipelineTrain(g, c["p0"], mesh=mesh, microbatches=c["accum"]) \
            if mesh is not None else \
            PipelineTrain(g, c["p0"], ["cpu"] * c["shape"]["pp"],
                          microbatches=c["accum"])
        cost, m = pt.step(x, y, 1e-3, generator=gen)
        full = pt.gather_params()
        return (tparams.train_params_to_numpy(g, full), float(cost),
                {k: float(v) for k, v in m.items()},
                None if gen is None else gen.get_state().numpy())
    mesh = mesh or grid_mesh(c["shape"], device="cpu")
    if "tp" in c["shape"]:
        sp = "sp" if "sp" in c["shape"] else None
        step, place = ttensor.make_tp_train_step(g, mesh, sp_axis=sp, **kw)
        placed, opts = place(p, o)
        placed, opts, cost, m = step(placed, opts, x, y, 1e-3)
        full = ttensor.gather(placed, mesh=mesh, graph=g)
    else:
        step = make_spatial_train_step(g, mesh, **kw)
        p, o, cost, m = step(p, o, x, y, 1e-3)
        full = p
    return (tparams.train_params_to_numpy(g, full), float(cost),
            {k: float(v) for k, v in m.items()}, None)


def _bn_parts_case(c, mesh):
    """bn_act_train_parts with this rank's 2 parts over the 2-rank group,
    and over one process with all 4 parts: the outputs, the statistics
    and the gradients of scales, beta and each of this rank's parts."""
    from darknet_tpu_torch.ops.collective import group_sum
    from darknet_tpu_torch.ops.train_epilogue import bn_act_train_parts

    dt = torch.bfloat16 if c.get("bf16") else torch.float32
    r = mesh.coords["dp"]
    ys = [torch.from_numpy(a).to(dt) for a in c["parts"]]
    gs = [torch.from_numpy(a) for a in c["grads"]]

    def run(parts, group, idx):
        parts = [t.clone().requires_grad_() for t in parts]
        sc = torch.from_numpy(c["scales"]).requires_grad_()
        be = torch.from_numpy(c["beta"]).requires_grad_()
        # the ranks' shares differ: the whole's rows are given
        count = sum(y.numel() // y.shape[-1] for y in ys)
        outs, (mean, var) = bn_act_train_parts(
            parts, sc, be, "leaky", dt if dt != torch.float32 else None,
            dt if dt != torch.float32 else None, group=group, count=count)
        torch.autograd.backward(outs, [gs[i].to(o.dtype)
                                       for i, o in zip(idx, outs)])
        d_sc, d_be = sc.grad, be.grad
        if group is not None:
            # each rank's own dgamma and dbeta, summed as the step does
            d_sc, d_be = group_sum(d_sc, group), group_sum(d_be, group)
        return ({f"out{i}": o.detach().float().numpy()
                 for i, o in zip(idx, outs)}
                | {f"dy{i}": t.grad.float().numpy()
                   for i, t in zip(idx, parts)}
                | {"mean": mean.numpy(), "var": var.numpy(),
                   "dscales": d_sc.numpy(), "dbeta": d_be.numpy()})

    mine = [2 * r, 2 * r + 1]
    got = run([ys[i] for i in mine], mesh.group, mine)
    want = run(ys, None, list(range(4)))
    return got, want


def mp_train_ranks(rank, out_dir, cases):
    """Each case: one step over its world grid and over the one-process
    mesh of the same shape in this rank (tests/test_torch_mp_train.py),
    or the bn_act_train_parts case; writes `<name>_<rank>.npz`."""
    torch.set_num_threads(1)
    for c in cases:
        mesh = _case_mesh(c)
        if mesh is None:
            continue
        if c["kind"] == "bn":
            got, want = _bn_parts_case(c, mesh)
            np.savez(os.path.join(out_dir, f"{c['name']}_{rank}.npz"),
                     **{f"got/{k}": v for k, v in got.items()},
                     **{f"want/{k}": v for k, v in want.items()})
            continue
        g = _train_case(c)
        got, cost, met, gstate = _step_once(c, g, mesh)
        want, wcost, wmet, wgstate = _step_once(c, g, None)
        states = {} if gstate is None else {"gstate": gstate,
                                            "wgstate": wgstate}
        if gstate is not None:
            # and the unsharded step with the same generator seed
            from darknet_tpu_torch.nn import params as tparams
            from darknet_tpu_torch.train.step import (init_opt_state,
                                                      make_train_step)

            p = tparams.train_params_to_torch(g, c["p0"], "cpu")
            gen = torch.Generator().manual_seed(c["gen"])
            p, _o, ucost, _m = make_train_step(g, accum=c["accum"])(
                p, init_opt_state(g, p), torch.from_numpy(c["x"]),
                torch.from_numpy(c["y"]), 1e-3, gen)
            states.update(_flat("unsharded", tparams.train_params_to_numpy(
                g, p)), ucost=float(ucost), ugstate=gen.get_state().numpy())
        np.savez(os.path.join(out_dir, f"{c['name']}_{rank}.npz"),
                 cost=cost, wcost=wcost, **states,
                 met=np.asarray([met[k] for k in sorted(met)]),
                 wmet=np.asarray([wmet[k] for k in sorted(wmet)]),
                 **_flat("got", got), **_flat("want", want))



def mp_nojax_ranks(rank, out_dir, cfg, x, y, p0, mesh):
    """tests/test_torch_nojax.py's model-parallel world of 2 ranks
    (`mesh`: the (dp=1, sp=2) grid that `spawn(shape=)` made): one
    spatial step, then a 2-stage PipelineForward of the folded params;
    writes `mp_<rank>.npz` (the cost, and the heads on stage 0's
    rank)."""
    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.nn import params as tparams
    from darknet_tpu_torch.parallel.mesh import world_mesh
    from darknet_tpu_torch.parallel.pipeline import PipelineForward
    from darknet_tpu_torch.parallel.spatial import make_spatial_train_step
    from darknet_tpu_torch.train.step import init_opt_state

    g = build_graph(cfg, train=True)
    step = make_spatial_train_step(g, mesh)
    p = tparams.train_params_to_torch(g, p0, "cpu")
    o = init_opt_state(g, p)
    p, o, cost, _m = step(p, o, torch.from_numpy(x), torch.from_numpy(y),
                          1e-3)
    gs = build_graph(cfg)
    tp = tparams.params_to_torch(gs, tparams.fuse_conv_batchnorm(gs, p0),
                                 "cpu")
    heads = PipelineForward(gs, tp, mesh=world_mesh({"pp": 2},
                                                    device="cpu"))(x)
    np.savez(os.path.join(out_dir, f"mp_{rank}.npz"), cost=float(cost),
             **({} if heads is None else _heads_np("head", heads)))
