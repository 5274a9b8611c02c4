"""Command-line interface, the `yolo_core` executable
(yolo_core.cpp:139-399; `darknet_tpu/apps/cli.py`) on torch: the train,
valid, image, video, multi-video and bench modes.

    python -m darknet_tpu_torch.apps.cli -mode video -data_file obj.data \
        -model_file yolov4.cfg -weights_file yolov4.weights \
        -input_file clip.y4m

Flags mirror the JAX package's (`-flag value` or `--flag=value`); -device
chooses the CUDA card (the default) or the CPU.  The streaming modes read
`.y4m` clips and PNG images with the port's own code, and other formats
through OpenCV where it is installed (`data/video`, `data/image`); they
draw with the port's own raster primitives; -save_output needs OpenCV's
mp4 writer and raises before any work without it.  -mode bench runs the
port's benchmark (`apps/bench.py`; arguments the CLI does not know, such
as a batch or --no-train, go to it); -benchmark_layers N profiles the
valid mode's network per layer first (`utils/profiler`: the trace report,
and from 2 the prefix-marginal table); -dbg_sync 1 synchronises the card
after every layer of any mode, 2 also stops at the first layer that
makes a NaN or an Inf (`utils/debug`); -show_imgs writes three augmented
samples a training batch.

-num_chips N (above 1; alias -num_gpus) is data parallelism: -mode train
starts N processes, one a device, joined by torch.distributed
(`parallel/multihost.spawn`: NCCL where each has a card of its own, gloo
where they share one or run on the CPU), each training on its block of
every batch; -mode valid and the multi-camera serving use a one-process
mesh of N devices (`parallel/mesh`), with no mesh where the camera batch
does not divide by N.  The devices are cuda:0..N-1 (N CPU entries with
-device cpu).  A mesh of more cards than the machine has raises.  The
model-parallel meshes (`parallel/{spatial,tensor,pipeline}.py`, in one
process or over a world) are not CLI flags.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yolo_core", description=__doc__, prefix_chars="-",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-mode", "--mode", default="video",
                   choices=["train", "valid", "image", "video",
                            "multi-video", "bench"])
    p.add_argument("-data_file", "--data_file", default="yolo.data")
    p.add_argument("-model_file", "--model_file", default="yolo.cfg")
    p.add_argument("-weights_file", "--weights_file", default="yolo.weights")
    p.add_argument("-input_file", "--input_file", default="test.avi",
                   help="comma-separated for multiple files")
    p.add_argument("-thresh", "--thresh", type=float, default=0.5)
    p.add_argument("-nms_thresh", "--nms_thresh", type=float, default=0.45)
    p.add_argument("-device", "--device", default="cuda",
                   choices=["cuda", "cpu"],
                   help="the CUDA card, or the CPU when named")
    p.add_argument("-clear", "--clear", action="store_true")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="restore the rolling full-state checkpoint "
                        "(<model>_last.ckpt.npz in the backup dir)")
    p.add_argument("-show_imgs", "--show_imgs", action="store_true")
    p.add_argument("-save_output", "--save_output", action="store_true",
                   help="write <name>_out.mp4 (mp4v; needs OpenCV)")
    p.add_argument("-disable_tracking", "--disable_tracking",
                   action="store_true")
    p.add_argument("-calc_map", "--calc_map", action="store_true",
                   default=True)
    p.add_argument("-no_calc_map", "--no_calc_map", dest="calc_map",
                   action="store_false")
    p.add_argument("-remat", "--remat", action="store_true",
                   help="recompute conv blocks in the backward pass")
    p.add_argument("-act16", "--act16", action="store_true",
                   help="force bf16 interlayer activations in training "
                        "(default: on for the card)")
    p.add_argument("-no_act16", "--no_act16", action="store_true",
                   help="force f32 interlayer activations in training")
    p.add_argument("-metric_lag", "--metric_lag", type=int, default=-1,
                   help="iterations queued before a step's metrics are "
                        "read; default: 3 on the card, 0 on the CPU")
    p.add_argument("-benchmark_layers", "--benchmark_layers", type=int,
                   default=0)
    p.add_argument("-int8", "--int8", action="store_true",
                   help="quantized inference (int8 convs); dynamic "
                        "activation scales unless -int8_calib")
    p.add_argument("-calib_file", "--calib_file", default="",
                   help="int8 calibration cache: load it if present, "
                        "else save the freshly computed scales there "
                        "(pair with -int8_calib)")
    p.add_argument("-coco_map", "--coco_map", action="store_true",
                   help="valid mode: also report COCO AP@[.5:.95] "
                        "(10-threshold sweep from the same predictions)")
    p.add_argument("-int8_calib", "--int8_calib", type=int, default=0,
                   help="valid mode: calibrate static activation scales "
                        "on the first N val images")
    p.add_argument("-dbg_sync", "--dbg_sync", "-cuda_dbg_sync",
                   "--cuda_dbg_sync", type=int, default=0, dest="dbg_sync")
    p.add_argument("-num_chips", "--num_chips", "-num_gpus", "--num_gpus",
                   type=int, default=1, dest="num_chips")
    p.add_argument("-loader_processes", "--loader_processes", type=int,
                   default=-1,
                   help="data-loader process workers (spawn pool); -1 = "
                   "auto, 0 = thread pool")
    p.add_argument("-geo_info_file", "--geo_info_file", default="")
    p.add_argument("-out_dir", "--out_dir", default="output")
    p.add_argument("-letter_box", "--letter_box", action="store_true",
                   help="aspect-preserving letterbox resize at inference")
    p.add_argument("-metrics_file", "--metrics_file", default="",
                   help="JSONL per-step training metrics output")
    p.add_argument("-device_nms", "--device_nms", default="auto",
                   choices=["auto", "on", "off"],
                   help="serve through the device program (decode, top-k, "
                        "NMS); auto = on when the network is on the card. "
                        "The device path keeps the top_k objectness "
                        "candidates per frame before NMS")
    p.add_argument("-top_k", "--top_k", type=int, default=256,
                   help="device serving path: candidates kept per image")
    p.add_argument("-pipeline_depth", "--pipeline_depth", type=int,
                   default=2,
                   help="video/multi-video: frames submitted to the device "
                        "before the oldest is finalized; results are "
                        "finalized strictly in order")
    p.add_argument("-latency", "--latency", action="store_true",
                   help="low-latency streaming preset: top_k=64, "
                        "pipeline_depth=1")
    return p


def _load_metadata(args):
    from darknet_tpu_torch.config.metadata import Metadata

    return Metadata.from_file(args.data_file)


def _load_network(args, train=False):
    from darknet_tpu_torch.nn.network import Network

    weights = args.weights_file if os.path.exists(args.weights_file) else None
    net = Network.from_cfg(args.model_file, weights=weights, train=train,
                           clear=args.clear, int8=args.int8 and not train,
                           device=args.device)
    # per-layer construction table on stderr, as every LoadNetwork of the
    # reference prints it (parser.cpp:1134-1135)
    print(net.graph.layer_table(), file=sys.stderr)
    if not train and args.int8 and args.calib_file and \
            os.path.exists(args.calib_file):
        net.load_calibration(args.calib_file)
    return net


def _mesh_devices(args) -> list:
    """The -num_chips mesh's devices: cuda:0..N-1 (N CPU entries with
    -device cpu); more cards than the machine has raise."""
    from darknet_tpu_torch.parallel.mesh import make_mesh

    return [str(d) for d in make_mesh(args.num_chips,
                                      device=args.device).devices]


def _serving_mesh(args, batch: int):
    """The one-process dp mesh of the serving paths when -num_chips > 1
    and the batch divides by it; None otherwise (one device)."""
    n = args.num_chips
    if n <= 1 or batch % n:
        return None
    mesh = getattr(args, "_serve_mesh", None)
    if mesh is None:
        from darknet_tpu_torch.parallel.mesh import make_mesh

        mesh = args._serve_mesh = make_mesh(devices=_mesh_devices(args))
    return mesh


def _train_rank(rank, args, devices):
    """One rank of -mode train -num_chips N (`parallel/multihost.spawn`)."""
    from darknet_tpu_torch.parallel.mesh import make_mesh

    with _debug_modes(args):
        mode_train(args, mesh=make_mesh(devices=devices))


def mode_train(args, mesh=None):
    from darknet_tpu_torch.train.trainer import DetectorTrainer

    if args.num_chips > 1 and mesh is None:
        from darknet_tpu_torch.parallel.multihost import spawn

        devices = _mesh_devices(args)
        spawn(_train_rank, devices, args, devices)
        return
    md = _load_metadata(args)
    train_paths = md.load_paths("train")
    val_paths = md.load_paths("valid") if (args.calc_map and md.valid_list) \
        else []
    with open(args.model_file) as f:
        cfg_text = f.read()
    trainer = DetectorTrainer(
        cfg_text, train_paths,
        weights=args.weights_file if os.path.exists(args.weights_file)
        else None,
        classes=md.classes, clear=args.clear,
        calc_map=args.calc_map and bool(val_paths), val_paths=val_paths,
        save_dir=md.backup_dir,
        save_name=os.path.splitext(os.path.basename(args.model_file))[0],
        metrics_path=args.metrics_file or None,
        show_imgs=3 if args.show_imgs else 0, remat=args.remat,
        act16=True if args.act16 else (False if args.no_act16 else None),
        loader_processes=args.loader_processes, resume=args.resume,
        metric_lag=None if args.metric_lag < 0 else args.metric_lag,
        device=args.device, mesh=mesh)
    try:
        if trainer.rank == 0:
            print(trainer.graph.layer_table(), file=sys.stderr)
        trainer.train()
    finally:
        trainer.close()


def mode_valid(args):
    from darknet_tpu_torch.data.image import (load_image_rgb,
                                              resize_image_darknet)
    from darknet_tpu_torch.eval.map import COCO_IOUS, validate_detector

    md = _load_metadata(args)
    net = _load_network(args)
    if args.benchmark_layers:
        # -benchmark_layers (network_kernels.cu:46-114): 1 = the per-layer
        # profiler report; 2 and up also the prefix-marginal table
        import torch

        from darknet_tpu_torch.utils.profiler import (benchmark_layers,
                                                      trace_report)

        xb = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (1, net.net.h, net.net.w, net.net.c)).astype(
                np.float32)).to(net.device)

        def _probe(p, x):
            # every head, so the profiled program is the whole graph
            with torch.inference_mode():
                r = net._fwd(p, x)
                outs = r["heads"] if r["heads"] else [r["output"]]
                return sum(o.float().sum() for o in outs)

        trace_report(_probe, net.forward_params, xb, graph=net.graph)
        if args.benchmark_layers >= 2:
            benchmark_layers(net.graph, net.params,
                             compute_dtype=net.compute_dtype,
                             fused_bn=net.fused)
    paths = md.load_paths("valid")
    # (_load_network already applied -calib_file if it existed)
    if args.int8 and args.int8_calib and net._calib_absmax is None:
        # static activation scales from the first N val images
        calib = [resize_image_darknet(load_image_rgb(p),
                                      net.net.w, net.net.h)
                 for p in paths[:args.int8_calib]]
        net.calibrate_int8(calib)
        if args.calib_file:
            if net._calib_absmax is not None:
                net.save_calibration(args.calib_file)
            else:
                print("int8 calibration: no quantized convs, "
                      f"not writing {args.calib_file}", file=sys.stderr)
    batch = 8 if len(paths) >= 8 else 1
    mesh = None
    if args.num_chips > 1:
        # a batch-sharded forward; host NMS and matching unchanged
        from darknet_tpu_torch.parallel.mesh import round_batch_to_mesh

        batch = round_batch_to_mesh(batch, args.num_chips)
        mesh = _serving_mesh(args, batch)
    # the reference's valid mode resizes with its own two-pass bilinear
    # (load_image + resize_image, data.cpp:695-698)
    res = validate_detector(net, paths, md.classes, iou_thresh=0.5,
                            batch=batch, resize="darknet", mesh=mesh,
                            iou_thresholds=(COCO_IOUS if args.coco_map
                                            else None))
    print(f"\n # of pred: {res.n_pred}\n # of GT: {res.n_gt}")
    print(f" Recall: {res.recall:.4g}%\n Precision: {res.precision:.4g}%")
    for cid, ap in enumerate(res.per_class_ap):
        print(f" cid = {cid}, name = {md.names[cid]}, ap = {ap * 100:.4g}%")
    print(f"\n mAP@0.5: {res.map * 100:.4g}%")
    if res.map_mean_iou is not None:
        print(f" AP@[.5:.95]: {res.map_mean_iou * 100:.4g}%")
    print(f" Total prediction time: {res.pred_time_s:.4g}s")
    print(f" Prediction per second: {res.imgs_per_s:.4g}")
    return res.map


# ------------------------------------------------------------ streaming

def _use_device_nms(args, net) -> bool:
    """-device_nms: on, off, or (auto) on when the network is on the
    card."""
    if args.device_nms != "auto":
        return args.device_nms == "on"
    return net.device.type == "cuda"


def _bgr_to_rgb(frame):
    """The channels reversed (BGR <-> RGB) into a new contiguous array, a
    channel at a time (a strided copy of all three is several times
    slower)."""
    out = np.empty_like(frame)
    n = frame.shape[-1]
    for c in range(n):
        out[..., c] = frame[..., n - 1 - c]
    return out


def _host_tail(net, md, frame_bgr, dets, args, track_manager=None):
    """Shared per-frame host tail: letterbox box correction -> most-prob
    dets -> track -> draw.  The synchronous, pipelined and batched paths
    all delegate here."""
    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.tracker import get_most_prob_dets

    if args.letter_box and dets:
        from darknet_tpu_torch.data.image import correct_boxes_letterbox

        ih, iw = frame_bgr.shape[:2]
        for d in dets:
            d.bbox = tuple(correct_boxes_letterbox(
                np.asarray(d.bbox), iw, ih, net.net.w, net.net.h))
    most_prob = get_most_prob_dets(dets)
    disp_rgb = _bgr_to_rgb(frame_bgr)
    if track_manager is not None:
        track_manager.track(most_prob)
        viz.draw_trackings(disp_rgb, track_manager.get_tracks(), md.names)
    else:
        viz.draw_detections(disp_rgb, most_prob, md.names)
    return _bgr_to_rgb(disp_rgb), most_prob


def _host_input(net, frame_bgr, args):
    """The host path's network input: f32 RGB in [0, 1], resized (cv's
    bilinear) or letterboxed on the host."""
    from darknet_tpu_torch.data.image import letterbox_image, resize_image_cv

    rgb = frame_bgr[..., ::-1].astype(np.float32) / 255.0
    if args.letter_box:
        return letterbox_image(rgb, net.net.w, net.net.h)
    return resize_image_cv(rgb, net.net.w, net.net.h)


def _proc_frame(net, md, frame_bgr, args, track_manager=None):
    """ProcImage (yolo_core.cpp:104-137): resize -> predict -> NMS ->
    most-prob dets -> track/draw.  The device path is submit + finalize
    (the streaming halves); the host path shares _host_tail."""
    if _use_device_nms(args, net):
        return _finalize_frame(net, md, frame_bgr,
                               _submit_frame(net, frame_bgr, args), args,
                               track_manager=track_manager)
    dets = net.detect(_host_input(net, frame_bgr, args), thresh=args.thresh,
                      nms=args.nms_thresh)
    return _host_tail(net, md, frame_bgr, dets, args, track_manager)


def _device_letterbox(net, frames_u8):
    """Shared on-device letterbox: (N,H,W,C) uint8 RGB frames -> an f32
    [0,1] letterboxed batch on the network's device; one letterbox per
    input geometry, cached on the Network."""
    from darknet_tpu_torch.data.image import make_letterbox_device

    _n, ih, iw, c = frames_u8.shape
    key = (ih, iw, net.net.w, net.net.h)
    cache = net.__dict__.setdefault("_lbx_cache", {})
    if key not in cache:
        cache[key] = make_letterbox_device(ih, iw, net.net.w, net.net.h, c,
                                           device=net.device)
    return cache[key](frames_u8)


def _submit_frame(net, frame_bgr, args):
    """Streaming half 1: run the device serving program for one frame and
    return its device triple without copying it to the host, so that the
    previous frame's track/draw/write overlaps the device.  The frame
    uploads as uint8 (resized on the host in cv's fixed point), or, with
    -letter_box, camera-native for the letterbox on the device."""
    from darknet_tpu_torch.data.image import resize_image_cv

    if args.letter_box:
        x = _device_letterbox(net, _bgr_to_rgb(frame_bgr)[None])
    else:
        x = resize_image_cv(_bgr_to_rgb(frame_bgr), net.net.w,
                            net.net.h)[None]
    return net.submit_detect_device(x, thresh=args.thresh,
                                    nms=args.nms_thresh, top_k=args.top_k)


def _finalize_frame(net, md, frame_bgr, out, args, track_manager=None):
    """Streaming half 2: copy a _submit_frame result to the host and run
    the shared host tail."""
    dets = net.device_out_to_dets(*out)[0]
    return _host_tail(net, md, frame_bgr, dets, args, track_manager)


def _proc_frames_batch(net, md, frames_bgr, args, track_managers=None):
    """Batched ProcImage for N cameras: one network predict per frame set
    (the reference's multi-video loop runs each camera at batch 1,
    yolo_core.cpp:276-392)."""
    sub = _submit_frames_batch(net, frames_bgr, args)
    return _finalize_frames_batch(net, md, frames_bgr, sub, args,
                                  track_managers)


def _submit_frames_batch(net, frames_bgr, args):
    """Streaming half 1 for N cameras: preprocess and run the batched
    device program (device path); the host path resolves synchronously."""
    from darknet_tpu_torch.data.image import resize_image_cv

    device = _use_device_nms(args, net)
    if args.letter_box and len({f.shape for f in frames_bgr}) == 1:
        # one resolution: letterbox on the device; the result stays there
        x = _device_letterbox(net, np.stack([_bgr_to_rgb(f)
                                             for f in frames_bgr]))
    elif not args.letter_box and device:
        x = np.stack([resize_image_cv(_bgr_to_rgb(f), net.net.w, net.net.h)
                      for f in frames_bgr])
    else:
        x = np.stack([_host_input(net, f, args) for f in frames_bgr])
    mesh = _serving_mesh(args, len(frames_bgr))
    if device:
        return ("dev", net.submit_detect_device(
            x, thresh=args.thresh, nms=args.nms_thresh, top_k=args.top_k,
            mesh=mesh))
    if not isinstance(x, np.ndarray):
        x = x.cpu().numpy()
    return ("host", net.detect_batch(x, thresh=args.thresh,
                                     nms=args.nms_thresh, mesh=mesh))


def _finalize_frames_batch(net, md, frames_bgr, sub, args,
                           track_managers=None):
    """Streaming half 2 for N cameras: copy to the host and run the shared
    host tail per camera."""
    kind, payload = sub
    dets_b = net.device_out_to_dets(*payload) if kind == "dev" else payload
    return [
        _host_tail(net, md, frame, dets, args,
                   track_managers[i] if track_managers else None)
        for i, (frame, dets) in enumerate(zip(frames_bgr, dets_b))
    ]


def _read_image(path):
    """A BGR uint8 image: PNG by the port's codec, another format through
    cv2 where it imports; None where the file cannot be read."""
    from darknet_tpu_torch.data.image import ImageDecodeError, read_png

    try:
        m = read_png(path)
    except (OSError, ImageDecodeError):
        m = None
    if m is not None:
        if m.shape[2] == 1:
            m = np.repeat(m, 3, axis=2)
        return np.ascontiguousarray(m[..., 2::-1])
    try:
        import cv2
    except ImportError:
        if not os.path.exists(path):
            return None
        raise RuntimeError(f"{path}: only 8-bit PNGs are read without "
                           f"OpenCV (cv2 is not installed)") from None
    return cv2.imread(path)


def _write_image(path, img_bgr) -> None:
    """PNG by the port's codec, another format through cv2 (raises
    without it)."""
    from darknet_tpu_torch.data.image import write_png

    if path.lower().endswith(".png"):
        write_png(path, _bgr_to_rgb(img_bgr))
        return
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{path}: only PNG is written without OpenCV "
                           f"(cv2 is not installed)") from None
    if not cv2.imwrite(path, img_bgr):
        raise OSError(f"could not write {path}")


def mode_image(args):
    from darknet_tpu_torch.apps import visualize as viz

    md = _load_metadata(args)
    net = _load_network(args)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.input_file.split(","):
        if not path:
            continue
        frame = _read_image(path)
        if frame is None:
            print(f"could not read {path}", file=sys.stderr)
            continue
        t0 = time.perf_counter()
        display, dets = _proc_frame(net, md, frame, args)
        dt = (time.perf_counter() - t0) * 1000
        print(f"{path}: {len(dets)} objects, {dt:.1f} ms")
        for d in dets:
            print(f"  {md.names[d.cid]}: {d.prob * 100:.0f}%")
        out = os.path.join(args.out_dir, "det_" + os.path.basename(path))
        _write_image(out, display)
        print(f"  saved {out}")
        viz.safe_imshow(args.mode, display, wait_ms=0)  # yolo_core.cpp:211


def _writer_for(args, path, fps, shape):
    from darknet_tpu_torch.data import video

    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir,
                       os.path.splitext(os.path.basename(path))[0]
                       + "_out.mp4")
    return video.open_writer(out, fps, (shape[1], shape[0]))


def mode_video(args):
    import queue
    import threading
    from collections import deque

    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.tracker import ConfParam, TrackManager
    from darknet_tpu_torch.data import video

    if args.save_output:
        video.require_writer()
    md = _load_metadata(args)
    net = _load_network(args)
    path = args.input_file.split(",")[0]
    cap = video.open_video(path)
    if cap is None or not cap.isOpened():
        print(f"could not open {path}", file=sys.stderr)
        return
    fps = cap.fps or 30.0
    max_frame = cap.frame_count

    tm = None
    if not args.disable_tracking:
        tm = TrackManager(ConfParam.from_fps(fps), fps, 0.3)

    # frame prefetch thread: decode the next frame while the card computes
    frames_q: "queue.Queue" = queue.Queue(maxsize=4)
    stop_evt = threading.Event()          # set by ESC in the live window
    read_error = []                       # a decode failure, raised below

    def _reader():
        try:
            while not stop_evt.is_set():
                ok, f = cap.read()
                if not ok:
                    break
                frames_q.put(f)
        except Exception as e:            # re-raised by the main thread
            read_error.append(e)
        finally:
            frames_q.put(None)

    reader_t = threading.Thread(target=_reader, daemon=True)
    reader_t.start()

    writer = None
    curr = 0
    gui = viz.gui_ok()

    def _emit(display, dt):
        nonlocal writer, curr
        rgb = _bgr_to_rgb(display)
        viz.draw_proc_time(rgb, dt)
        viz.draw_frame_info(rgb, curr, max_frame)
        out_bgr = _bgr_to_rgb(rgb)
        if args.save_output:
            if writer is None:
                writer = _writer_for(args, path, fps, out_bgr.shape)
            writer.write(out_bgr)
        if gui and viz.safe_imshow(args.mode, out_bgr) == 27:
            stop_evt.set()                # yolo_core.cpp:267-268: ESC
        curr += 1

    try:
        if _use_device_nms(args, net):
            # depth-N pipeline: up to N frames' device programs run while
            # the host finalizes the oldest; results stay strictly in order
            depth = max(1, args.pipeline_depth)
            pending: "deque" = deque()   # (frame, device triple, submit s)
            eof = False
            while True:
                if not eof:
                    frame = frames_q.get()
                    if stop_evt.is_set():
                        frame = None     # ESC: finalize pending and stop
                    if frame is None:
                        eof = True
                    else:
                        t0 = time.perf_counter()
                        out = _submit_frame(net, frame, args)
                        pending.append((frame, out,
                                        time.perf_counter() - t0))
                while pending and (eof or len(pending) > depth):
                    pframe, pout, sub_dt = pending.popleft()
                    # proc time = submit + finalize, not the wait on the
                    # frame source in between
                    t0 = time.perf_counter()
                    display, _ = _finalize_frame(net, md, pframe, pout, args,
                                                 track_manager=tm)
                    _emit(display, (sub_dt + time.perf_counter() - t0) * 1000)
                if eof and not pending:
                    break
        else:
            while True:
                frame = frames_q.get()
                if frame is None or stop_evt.is_set():
                    break
                t0 = time.perf_counter()
                display, _ = _proc_frame(net, md, frame, args,
                                         track_manager=tm)
                _emit(display, (time.perf_counter() - t0) * 1000)
        if read_error:
            raise RuntimeError(f"{path}: reading a frame failed") \
                from read_error[0]
    finally:
        # the reader may be blocked on a full queue: signal it, drain, and
        # release the capture only once it is done
        stop_evt.set()
        while True:
            try:
                frames_q.get_nowait()
            except queue.Empty:
                break
        reader_t.join(timeout=2.0)
        if not reader_t.is_alive():
            cap.release()
        if writer is not None:
            writer.release()
    print(f"processed {curr} frames")


def mode_multi_video(args):
    """N cameras, N trackers, handover crosstalk between the first two
    cameras' zones (yolo_core.cpp:276-392), one network predict per frame
    set."""
    from collections import deque

    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.geo import GeoInfo, Handover
    from darknet_tpu_torch.apps.tracker import ConfParam, TrackManager
    from darknet_tpu_torch.data import video

    if args.save_output:
        video.require_writer()
    md = _load_metadata(args)
    net = _load_network(args)
    files = [f for f in args.input_file.split(",") if f]
    caps = []
    for f in files:
        cap = video.open_video(f)
        if cap is None or not cap.isOpened():
            print(f"could not open {f}", file=sys.stderr)
            return
        caps.append(cap)
    fps = (caps[0].fps or 30.0) if caps else 30.0
    tms = [TrackManager(ConfParam.from_fps(fps), fps, 0.3) for _ in files]
    geos = []
    for f in files:
        g = GeoInfo()
        xml = args.geo_info_file or os.path.splitext(f)[0] + ".xml"
        if os.path.exists(xml):
            g.load(xml, fps=fps)
        geos.append(g)

    writers = [None] * len(files)
    curr = 0

    def _read_set():
        frames = []
        for cap in caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frames.append(frame)
        return frames

    gui = viz.gui_ok()
    stop = False
    max_frame = caps[0].frame_count if caps else 0

    def _tail(outs, proc_ms):
        nonlocal curr, stop
        for i, (display, _dets) in enumerate(outs):
            geos[i].proc(tms[i].get_tracks())
            # zone overlay per camera (yolo_core.cpp:351-352), BGR frames
            geos[i].draw(display, bgr=True)
            rgb = _bgr_to_rgb(display)
            viz.draw_proc_time(rgb, proc_ms)
            viz.draw_frame_info(rgb, curr, max_frame)
            display[:] = _bgr_to_rgb(rgb)
            if args.save_output:
                if writers[i] is None:
                    writers[i] = _writer_for(args, files[i], fps,
                                             display.shape)
                writers[i].write(display)
            # one window per camera (yolo_core.cpp:378-379); ESC stops all
            if gui and viz.safe_imshow(f"{args.mode}-{i}", display) == 27:
                stop = True
        # cross-camera label handover between the first two cameras' zones
        if len(geos) >= 2 and geos[0].handovers and geos[1].handovers:
            Handover.crosstalk(geos[0].handovers[0], geos[1].handovers[0])
        curr += 1

    try:
        if _use_device_nms(args, net):
            # depth-N pipeline across frame sets (see mode_video)
            depth = max(1, args.pipeline_depth)
            pending: "deque" = deque()
            eof = False
            while True:
                if not eof:
                    frames = None if stop else _read_set()
                    if frames is None:
                        eof = True
                    else:
                        t0 = time.perf_counter()
                        pending.append(
                            (frames, _submit_frames_batch(net, frames, args),
                             time.perf_counter() - t0))
                while pending and (eof or len(pending) > depth):
                    pframes, psub, sub_dt = pending.popleft()
                    t0 = time.perf_counter()
                    outs = _finalize_frames_batch(net, md, pframes, psub,
                                                  args, track_managers=tms)
                    _tail(outs, (sub_dt + time.perf_counter() - t0) * 1000)
                if eof and not pending:
                    break
        else:
            while True:
                frames = _read_set()
                if frames is None or stop:
                    break
                t0 = time.perf_counter()
                outs = _proc_frames_batch(net, md, frames, args,
                                          track_managers=tms)
                _tail(outs, (time.perf_counter() - t0) * 1000)
    finally:
        for cap in caps:
            cap.release()
        for wr in writers:
            if wr is not None:
                wr.release()
    print(f"processed {curr} frames from {len(files)} cameras")


def mode_bench(args, bench_argv):
    """The port's benchmark (`apps/bench.py`) on -device, with the
    arguments the CLI does not know (a batch, --bf16, --headline-only,
    --no-train, --size)."""
    from darknet_tpu_torch.apps import bench

    bench.main(list(bench_argv) + ["--device", args.device])


def _debug_modes(args) -> contextlib.ExitStack:
    """-cuda_dbg_sync (dark_cuda.h:9): the card synchronised after every
    layer, and from 2 the first NaN or Inf raises; both restored when
    the stack closes."""
    stack = contextlib.ExitStack()
    if args.dbg_sync:
        from darknet_tpu_torch.utils import debug

        stack.enter_context(debug.debug_sync_mode())
        if args.dbg_sync >= 2:
            stack.enter_context(debug.debug_nans())
    return stack


def main(argv=None):
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.mode != "bench":
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.latency:
        # low-latency preset: top_k=64, depth 1 (the freshest result)
        if args.top_k == parser.get_default("top_k"):
            args.top_k = 64
        args.pipeline_depth = 1
    if args.num_chips > 1:
        _mesh_devices(args)        # a mesh the machine cannot hold raises
    with _debug_modes(args):
        if args.mode == "train":
            mode_train(args)
        elif args.mode == "valid":
            # not the mAP: a console script passes main's value to sys.exit
            mode_valid(args)
        elif args.mode == "image":
            mode_image(args)
        elif args.mode == "video":
            mode_video(args)
        elif args.mode == "multi-video":
            mode_multi_video(args)
        else:
            mode_bench(args, rest)


if __name__ == "__main__":
    main()
