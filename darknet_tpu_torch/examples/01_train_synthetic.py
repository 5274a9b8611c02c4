"""Train a small detector end-to-end on generated data with the PyTorch
port: no dataset or network access needed.

Demonstrates:
  * darknet_tpu_torch.data.synth.generate: a learnable synthetic shapes
    dataset with darknet labels and a .data/.names pair;
  * train.trainer.train_detector: the reference TrainDetector entry
    (detector.cpp:27-324): augmenting loader, training step, LR schedule
    with burn-in, checkpoints under the .data backup dir;
  * eval.map.validate_detector: the reference ValidateDetector (mAP@0.5,
    per-class AP) on the held-out split.

Runs on the CUDA card (--device cpu for the CPU).  Artifacts land in
--workdir and feed examples 02-04.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import SHAPES_CFG, base_parser, workdir_paths  # noqa: E402


def main() -> None:
    ap = base_parser(__doc__)
    ap.add_argument("--iters", type=int, default=300,
                    help="training iterations (use 20 for a quick smoke)")
    ap.add_argument("--images", type=int, default=240,
                    help="synthetic training images to generate")
    args = ap.parse_args()

    paths = workdir_paths(args.workdir)
    os.makedirs(args.workdir, exist_ok=True)

    from darknet_tpu_torch.data.synth import generate

    print(f"generating {args.images}+48 synthetic shape images ...")
    generate(paths["dataset"], n_train=args.images, n_val=48, seed=1234)
    with open(paths["cfg"], "w") as f:
        f.write(SHAPES_CFG)
    # point the .data file's backup dir at the workdir (the reference's
    # `save=` key; checkpoints + chart.png go there)
    with open(paths["data"], "a") as f:
        f.write(f"save = {paths['backup']}\n")

    from darknet_tpu_torch.train.trainer import train_detector

    print(f"training {args.iters} iterations on {args.device} ...")
    final_loss = train_detector(paths["data"], paths["cfg"],
                                max_iters=args.iters, device=args.device)
    print(f"final EMA loss: {final_loss:.3f}")
    assert os.path.exists(paths["weights"]), paths["weights"]

    # held-out mAP with the trained weights
    from darknet_tpu_torch.config.metadata import Metadata
    from darknet_tpu_torch.eval.map import validate_detector
    from darknet_tpu_torch.nn.network import Network

    md = Metadata.from_file(paths["data"])
    net = Network.from_cfg(paths["cfg"], weights=paths["weights"],
                           device=args.device)
    res = validate_detector(net, md.load_paths("valid"), classes=md.classes,
                            batch=8, progress=False)
    for cid, name in enumerate(md.names):
        print(f"  class {cid} ({name}): AP = {res.per_class_ap[cid]:.4f}")
    print(f"mAP@0.5 = {res.map:.4f}  ({res.imgs_per_s:.1f} img/s)")
    print(f"\nartifacts: {paths['cfg']}  {paths['weights']}")
    print("next: python darknet_tpu_torch/examples/02_detect.py")


if __name__ == "__main__":
    main()
