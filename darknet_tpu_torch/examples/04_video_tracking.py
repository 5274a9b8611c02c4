"""Streaming video inference with multi-object tracking, on the port.

Synthesizes a short clip of moving shapes (no video file needed), then
runs the streaming loop:

  * submit_detect_device + device_out_to_dets as submit and finalize
    halves: the next frame's device program is queued BEFORE the current
    frame's host tail runs (CUDA's asynchronous launches overlap device
    and host work; the CLI's video mode uses the same pattern);
  * apps.tracker.TrackManager: Kalman-filter prediction + Hungarian IoU
    association (track_manager.cpp semantics);
  * apps.visualize.draw_trackings, and the annotated clip written as a
    .y4m by data.video.write_y4m (no OpenCV needed).

For real videos use the CLI:
  python -m darknet_tpu_torch.apps.cli -mode video -data_file ... \\
      -model_file ... -weights_file ... -input_file clip.y4m
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _common import base_parser, require_trained, workdir_paths  # noqa: E402

FPS = 15
N_FRAMES = 45
W, H = 256, 192


def synth_frames():
    """Moving shapes on a noise background, colored like the training
    classes (red rectangle moving right, blue circle moving down-left)."""
    import numpy as np

    rng = np.random.default_rng(7)
    for t in range(N_FRAMES):
        img = rng.integers(90, 130, (H, W, 3)).astype(np.uint8)
        # red rectangle, constant velocity
        x0 = 10 + int(t * 3.5)
        y0 = 40
        img[y0:y0 + 56, x0:x0 + 64] = (210, 40, 40)
        # blue circle
        cx, cy = W - 50 - t * 2, 60 + t * 2
        yy, xx = np.mgrid[0:H, 0:W]
        mask = ((xx - cx) / 28.0) ** 2 + ((yy - cy) / 28.0) ** 2 <= 1.0
        img[mask] = (40, 70, 220)
        yield img


def main() -> None:
    ap = base_parser(__doc__)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--weights", default=None)
    args = ap.parse_args()

    paths = workdir_paths(args.workdir)
    cfg = args.cfg or paths["cfg"]
    weights = args.weights or paths["weights"]
    if args.cfg is None:
        require_trained(paths)

    import time

    import numpy as np

    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.tracker import (ConfParam, TrackManager,
                                                get_most_prob_dets)
    from darknet_tpu_torch.config.metadata import Metadata
    from darknet_tpu_torch.data.image import resize_image_cv
    from darknet_tpu_torch.data.video import write_y4m
    from darknet_tpu_torch.nn.network import Network

    net = Network.from_cfg(cfg, weights=weights, device=args.device)
    names = (Metadata.from_file(paths["data"]).names
             if os.path.exists(paths["data"]) else [])
    tracker = TrackManager(ConfParam.from_fps(FPS), FPS, iou_thresh=0.3)

    def submit(frame):
        """Queue the device program; returns the device triple."""
        x = resize_image_cv(frame.astype(np.float32) / 255.0,
                            net.net.w, net.net.h)
        return net.submit_detect_device(x[None], top_k=64)

    pending = None
    frames = list(synth_frames())
    shown = []
    t0 = time.perf_counter()
    n_tracked = 0
    for i, frame in enumerate(frames + [None]):
        nxt = submit(frame) if frame is not None else None
        if pending is not None:
            # finalize the PREVIOUS frame while `nxt` runs on the device
            dets = Network.device_out_to_dets(*pending)[0]
            tracker.track(get_most_prob_dets(dets))
            disp = frames[i - 1].copy()
            viz.draw_trackings(disp, tracker.get_tracks(), names)
            viz.draw_frame_info(disp, i - 1, N_FRAMES)
            shown.append(disp[..., ::-1])                # BGR for the file
            n_tracked = max(n_tracked, len(tracker.get_tracks()))
        pending = nxt
    dt = time.perf_counter() - t0
    out_path = os.path.join(args.workdir, "tracking.y4m")
    write_y4m(out_path, shown, FPS)

    labels = sorted({t.label for t in tracker.get_tracks() if t.label >= 0})
    print(f"{N_FRAMES} frames in {dt:.2f}s ({N_FRAMES / dt:.1f} fps on "
          f"{args.device}, first calls included), {n_tracked} concurrent "
          f"tracks, labels {labels}")
    print(f"output video: {out_path}")


if __name__ == "__main__":
    main()
