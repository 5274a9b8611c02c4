"""Command-line interface, the `yolo_core` executable
(yolo_core.cpp:139-399; `darknet_tpu/apps/cli.py`): the train and valid
modes on torch.

    python -m darknet_tpu_torch.apps.cli -mode valid -data_file obj.data \
        -model_file yolov4.cfg -weights_file yolov4.weights

Flags mirror the JAX package's (`-flag value` or `--flag=value`); -device
chooses the CUDA card (the default) or the CPU.  Not ported yet, each
raising NotImplementedError before any work: the image, video,
multi-video and bench modes, -benchmark_layers, -dbg_sync and -show_imgs
(ROADMAP A6), and -num_chips above 1 (ROADMAP A7).
"""

from __future__ import annotations

import argparse
import os
import sys

UNPORTED_MODES = ("image", "video", "multi-video", "bench")
UNPORTED_FLAGS = ("benchmark_layers", "dbg_sync", "show_imgs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yolo_core", description=__doc__, prefix_chars="-",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-mode", "--mode", default="video",
                   choices=["train", "valid", *UNPORTED_MODES])
    p.add_argument("-data_file", "--data_file", default="yolo.data")
    p.add_argument("-model_file", "--model_file", default="yolo.cfg")
    p.add_argument("-weights_file", "--weights_file", default="yolo.weights")
    p.add_argument("-device", "--device", default="cuda",
                   choices=["cuda", "cpu"],
                   help="the CUDA card, or the CPU when named")
    p.add_argument("-clear", "--clear", action="store_true")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="restore the rolling full-state checkpoint "
                        "(<model>_last.ckpt.npz in the backup dir)")
    p.add_argument("-show_imgs", "--show_imgs", action="store_true")
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
    p.add_argument("-metrics_file", "--metrics_file", default="",
                   help="JSONL per-step training metrics output")
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


def mode_train(args):
    from darknet_tpu_torch.train.trainer import DetectorTrainer

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
        metrics_path=args.metrics_file or None, remat=args.remat,
        act16=True if args.act16 else (False if args.no_act16 else None),
        loader_processes=args.loader_processes, resume=args.resume,
        metric_lag=None if args.metric_lag < 0 else args.metric_lag,
        device=args.device)
    try:
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
    # the reference's valid mode resizes with its own two-pass bilinear
    # (load_image + resize_image, data.cpp:695-698)
    res = validate_detector(net, paths, md.classes, iou_thresh=0.5,
                            batch=batch, resize="darknet",
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode in UNPORTED_MODES:
        raise NotImplementedError(
            f"-mode {args.mode} is not ported yet (ROADMAP A6)")
    if args.num_chips > 1:
        raise NotImplementedError(
            "-num_chips above 1 is not ported yet (ROADMAP A7)")
    for flag in UNPORTED_FLAGS:
        if getattr(args, flag):
            raise NotImplementedError(
                f"-{flag} is not ported yet (ROADMAP A6)")
    if args.mode == "train":
        mode_train(args)
    else:
        # not the mAP: a console script passes main's value to sys.exit
        mode_valid(args)


if __name__ == "__main__":
    main()
