"""Data parallelism over several devices: mesh serving and a data-parallel
training step, the port's twin of examples/05_multichip.py.

Demonstrates:

  * parallel.mesh.make_mesh: the `dp` mesh (the replacement for the
    reference's pthread-per-GPU replicas and PCIe weight averaging,
    network_kernels.cu:295-484);
  * Network.detect_batch_device(mesh=...): multi-device serving in one
    process, each device holding a replica of the serving state and
    serving its block of the batch;
  * parallel.dp.make_dp_train_step: one process a device
    (parallel.multihost.spawn, torch.distributed), each rank stepping on
    its block of the global batch; batch-norm statistics and gradients
    are summed over the ranks every step, so every rank ends the step
    with the same weights.

The mesh is cuda:0..N-1 (--chips, default 2), or N CPU entries with
--device cpu.  It runs on any machine: with fewer cards than --chips the
mesh names the cards in turn and says so (two ranks on one card talk
through gloo).  Needs the 01 workdir.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import base_parser, require_trained, workdir_paths  # noqa: E402


def dp_rank(rank, cfg, weights, devices):
    """One rank of the data-parallel step (run by multihost.spawn)."""
    import numpy as np
    import torch
    import torch.distributed

    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.dp import make_dp_train_step
    from darknet_tpu_torch.parallel.mesh import make_mesh
    from darknet_tpu_torch.parallel.multihost import process_batch_slice
    from darknet_tpu_torch.train.step import init_opt_state
    from darknet_tpu_torch.weights import io as wio

    mesh = make_mesh(devices=devices)
    dev = mesh.devices[0]
    graph = build_graph(cfg, train=True)
    loaded, _seen, _ = wio.load_weights(graph, weights)
    init = paramlib.init_params(graph, seed=0)
    params = paramlib.train_params_to_torch(
        graph, [p if p else i for p, i in zip(loaded, init)], dev)
    opt = init_opt_state(graph, params)
    step = make_dp_train_step(graph, mesh, accum=max(graph.net.subdiv, 1))

    # the global batch, drawn alike on every rank: one box an image
    b = graph.net.optimizer_batch
    rng = np.random.default_rng(0)
    x = rng.random((b, graph.net.h, graph.net.w, 3), np.float32)
    truths = np.zeros((b, graph.heads()[-1].max_boxes, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    start, size = process_batch_slice(b)
    rows = slice(start, start + size)
    params, opt, loss, _ = step(params, opt,
                                torch.from_numpy(x[rows]).to(dev),
                                torch.from_numpy(truths[rows]).to(dev),
                                graph.net.lr)
    digest = float(sum(v.detach().double().sum() for p in params
                       for v in p.values()))
    # rank 0 prints every rank's line, so that the lines do not interleave
    lines = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(
        lines, f"rank {rank} on {dev}: images {start}-{start + size - 1} of "
        f"{b}, loss = {float(loss):.3f}, weights digest {digest:.6f}")
    if rank == 0:
        print("\n".join(lines), flush=True)


def main() -> None:
    ap = base_parser(__doc__)
    ap.add_argument("--chips", type=int, default=2,
                    help="devices on the dp axis")
    ap.add_argument("--thresh", type=float, default=0.25)
    args = ap.parse_args()
    paths = workdir_paths(args.workdir)
    require_trained(paths)

    import glob

    import numpy as np

    from darknet_tpu_torch.data import image as imlib
    from darknet_tpu_torch.nn.network import Network
    from darknet_tpu_torch.parallel.mesh import make_mesh
    from darknet_tpu_torch.parallel.multihost import spawn

    devices = None
    if args.device != "cpu":
        import torch

        cards = torch.cuda.device_count()
        if 0 < cards < args.chips:
            # a demo mesh on a smaller machine: the cards in turn
            devices = [f"cuda:{i % cards}" for i in range(args.chips)]
            print(f"{cards} card(s) for --chips {args.chips}: the mesh "
                  f"names {','.join(devices)}")
    mesh = make_mesh(args.chips, device=args.device, devices=devices)
    print(f"mesh: {mesh}")

    # ---- mesh serving: one process, the batch split over the devices ----
    net = Network.from_cfg(paths["cfg"], weights=paths["weights"],
                           device=mesh.devices[0])
    img_paths = sorted(glob.glob(os.path.join(paths["dataset"],
                                              "va_*.png")))[:4 * args.chips]
    x = np.stack([imlib.resize_image_cv(imlib.load_image_rgb(p),
                                        net.net.w, net.net.h)
                  for p in img_paths])
    dets = net.detect_batch_device(x, thresh=args.thresh, mesh=mesh)
    one = net.detect_batch_device(x, thresh=args.thresh)
    same = [[d.bbox for d in a] for a in dets] == \
        [[d.bbox for d in b] for b in one]
    print(f"mesh serving: {x.shape[0]} images -> "
          f"{sum(len(d) for d in dets)} detections "
          f"({x.shape[0] // args.chips} an image block a device; "
          f"{'the same boxes as' if same else 'other boxes than'} "
          f"one device)")

    # ---- data-parallel training: one process a device ----
    spawn(dp_rank, [str(d) for d in mesh.devices], paths["cfg"],
          paths["weights"], [str(d) for d in mesh.devices])
    print("every rank summed its gradients and batch-norm statistics with "
          "the others inside the step: equal digests mean equal weights")


if __name__ == "__main__":
    main()
