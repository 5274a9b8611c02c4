"""Single-image detection with the port's Python API.

Demonstrates:
  * Network.from_cfg(cfg, weights=..., device=...): LoadNetwork with
    automatic conv+BN fusion for inference (network.cpp:647-682);
  * data.image helpers: reference-exact bilinear resize or letterbox;
  * net.detect(...): GetNetworkBoxes + NmsSort semantics;
  * detections_to_json: the reference's Detection2Json export;
  * apps.visualize.draw_detections: the annotated image, written as PNG
    by data.image.write_png (no OpenCV needed).

By default detects on a held-out image from the 01 workdir; pass
--image/--cfg/--weights to use your own (reference-format artifacts
work as-is).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import base_parser, require_trained, workdir_paths  # noqa: E402


def main() -> None:
    ap = base_parser(__doc__)
    ap.add_argument("--image", default=None, help="input image path")
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--thresh", type=float, default=0.25)
    ap.add_argument("--letterbox", action="store_true",
                    help="aspect-preserving letterbox instead of the "
                         "reference's plain resize (yolo_core.cpp:108)")
    args = ap.parse_args()

    paths = workdir_paths(args.workdir)
    cfg = args.cfg or paths["cfg"]
    weights = args.weights or paths["weights"]
    if args.cfg is None:
        require_trained(paths)
    image = args.image or os.path.join(paths["dataset"], "va_0000.png")

    from darknet_tpu_torch.config.metadata import Metadata
    from darknet_tpu_torch.data import image as imlib
    from darknet_tpu_torch.nn.network import Network, detections_to_json

    net = Network.from_cfg(cfg, weights=weights, device=args.device)

    im = imlib.load_image_rgb(image)                     # HWC float [0,1]
    if args.letterbox:
        x = imlib.letterbox_image(im, net.net.w, net.net.h)
    else:
        x = imlib.resize_image_cv(im, net.net.w, net.net.h)

    dets = net.detect(x, thresh=args.thresh)

    names = []
    if args.cfg is None and os.path.exists(paths["names"]):
        names = Metadata.from_file(paths["data"]).names
    h, w = im.shape[:2]
    for d in dets:
        cx, cy, bw, bh = d.bbox                          # relative center fmt
        label = (names[d.best_class] if d.best_class < len(names)
                 else str(d.best_class))
        print(f"{label}: {d.best_prob:.2f}  "
              f"box=({cx * w:.0f},{cy * h:.0f} {bw * w:.0f}x{bh * h:.0f})px")
    print("\nJSON:", detections_to_json(dets, frame_id=0, names=names))

    # annotated image
    import numpy as np

    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.tracker import get_most_prob_dets

    disp = (im * 255).astype(np.uint8).copy()
    viz.draw_detections(disp, get_most_prob_dets(dets), names)
    out = os.path.join(args.workdir, "detections.png")
    imlib.write_png(out, disp)
    print(f"annotated image: {out}")


if __name__ == "__main__":
    main()
