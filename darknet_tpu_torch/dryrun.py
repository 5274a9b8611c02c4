"""One training step over a model-parallel mesh, the twin of the JAX
package's `dryrun_multichip` (`__graft_entry__.py:71-200,277-299`).

    python -m darknet_tpu_torch.dryrun 8            # on the card(s)
    python -m darknet_tpu_torch.dryrun 8 --device cpu

yolov4-tiny at 128 px (4x4 and 8x8 yolo grids), batch max(2 n_dp, 2),
seeded uniform pixels and one box an image, trains one step with
subdivisions 2 (accum=2) over a mesh of `n_devices`, by the JAX
package's rule: (dp, sp, tp) = (2, 2, n/4) when 8 divides n
(`parallel/tensor.make_tp_train_step(sp_axis="sp")`), (dp, sp) = (2,
n/2) when n is even, else (1, n) (`parallel/spatial.
make_spatial_train_step`); the cost must be finite.  Then a 2-stage
`parallel/pipeline.PipelineTrain` step with 2 micro-batches.

One process drives every device of the mesh.  On the card the mesh is
cuda:0..n-1, or the card named n times where fewer cards are present;
device="cpu" names the CPU n times.  The JAX package's `_stem_check` (the
packed train stem under a mesh) has no twin: `fused_stem_train` is on
ROADMAP's do-not-port list, and the port trains layers 0-1 as plain
convs.
"""

from __future__ import annotations

import argparse
import warnings

import numpy as np
import torch

SIZE = 128


def mesh_shape(n_devices: int) -> dict:
    """The JAX dryrun's mesh rule for n devices."""
    if n_devices % 8 == 0:
        return {"dp": 2, "sp": 2, "tp": n_devices // 4}
    if n_devices % 2 == 0:
        return {"dp": 2, "sp": n_devices // 2}
    return {"dp": 1, "sp": n_devices}


def mesh_devices(n_devices: int, device: str = "cuda") -> list:
    """n devices: the CPU named n times for device="cpu"; else
    cuda:0..n-1, or cuda:0 named n times when the machine has fewer
    cards (none raises)."""
    if device == "cpu":
        return ["cpu"] * n_devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA card: pass device=\"cpu\" to run the "
                           "dryrun on the CPU")
    if count >= n_devices:
        return [f"cuda:{i}" for i in range(n_devices)]
    return ["cuda:0"] * n_devices


def dryrun_batch(batch: int, seed: int):
    """(x, truths) of the dryrun: uniform pixels, one box an image."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    truths = np.zeros((batch, 8, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.25, 0.25, 1]
    return x, truths


def dryrun_graph(batch: int):
    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch.graph.builder import build_graph

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(model_zoo.yolov4_tiny_cfg(SIZE, SIZE, batch=batch,
                                                     subdiv=1), train=True)


def dryrun_multichip(n_devices: int, *, device: str = "cuda") -> dict:
    """One training step over an n-device mesh, then the 2-stage
    pipeline step (the module docstring).  Returns {"mesh", "devices",
    "cost", "count", "pp_cost"}; raises on a non-finite cost."""
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.mesh import grid_mesh
    from darknet_tpu_torch.parallel.pipeline import PipelineTrain
    from darknet_tpu_torch.parallel.spatial import make_spatial_train_step
    from darknet_tpu_torch.parallel.tensor import make_tp_train_step
    from darknet_tpu_torch.train.step import init_opt_state

    shape = mesh_shape(n_devices)
    devices = mesh_devices(n_devices, device)
    batch = max(2 * shape["dp"], 2)
    graph = dryrun_graph(batch)
    p0 = paramlib.init_params(graph, seed=0)
    home = torch.device(devices[0])
    params = paramlib.train_params_to_torch(graph, p0, home)
    opt_state = init_opt_state(graph, params)
    x, truths = dryrun_batch(batch, 0)
    mesh = grid_mesh(shape, devices=devices)
    lr = 1e-3
    if "tp" in shape:
        # accum=2: the subdivisions' gradient sum composed with the mesh
        step, place = make_tp_train_step(graph, mesh, sp_axis="sp", accum=2)
        placed, opts, xt, tt = place(params, opt_state, x, truths)
        _p, _o, cost, metrics = step(placed, opts, xt, tt, lr)
    else:
        step = make_spatial_train_step(graph, mesh, accum=2)
        _p, _o, cost, metrics = step(params, opt_state,
                                     torch.from_numpy(x).to(home),
                                     torch.from_numpy(truths).to(home), lr)
    cost = float(cost)
    if not np.isfinite(cost):
        raise FloatingPointError(f"dryrun_multichip({n_devices}): "
                                 f"non-finite cost {cost}")
    axes = ",".join(shape)
    dims = "x".join(str(v) for v in shape.values())
    print(f"dryrun_multichip({n_devices}): one train step over a {dims} "
          f"({axes}) mesh of {devices} OK, cost={cost:.4f}, "
          f"count={int(metrics['count'])}", flush=True)
    out = {"mesh": shape, "devices": devices, "cost": cost,
           "count": float(metrics["count"]), "pp_cost": None}
    if n_devices >= 2:
        xp, yp = dryrun_batch(batch, 1)
        pt = PipelineTrain(graph, p0, devices[:2], microbatches=2)
        pp_cost, pp_m = pt.step(xp, yp, lr)
        pp_cost = float(pp_cost)
        if not np.isfinite(pp_cost):
            raise FloatingPointError(f"dryrun_multichip({n_devices}): "
                                     f"non-finite pipeline cost {pp_cost}")
        print(f"  + pp: one GPipe train step over 2 stages (cuts "
              f"{pt.cuts}) OK, cost={pp_cost:.4f}, "
              f"count={int(pp_m['count'])}", flush=True)
        out["pp_cost"] = pp_cost
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="one model-parallel training step (the dryrun)")
    parser.add_argument("n_devices", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
