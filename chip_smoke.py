"""Smoke run of darknet_tpu_torch on one CUDA card: build the region
kernel, the conv epilogue and the int8 GEMM, check each against its
plain version, serve
yolov4-608 through the public API in bf16 and in int8, train it,
validate it and the rest of the yolo zoo, stream video through the CLI,
serve, resize, train and validate Gaussian YOLOv3, serve and train
YOLOv1 and the rare layer kinds, run the CLI's bench, per-layer
profile, debug and augmentation-sample flags, serve region_int8, train
from pinned bf16 uploads, export the serving program and serve it from
another process, run the C ABI twin and the walkthrough twins, train,
serve and validate over data-parallel meshes, serve and train over
model-parallel meshes (spatial, tensor, pipeline), and report.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. the card's name and power limit (nvidia-smi); a CUDA card is required;
  2. build the CUDA kernels from darknet_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  3. the region kernels against their plain version on the card: yolov4's
     region prefix at 608 px (b=2) and 416 px (b=1), f32 (the FFMA kernel,
     TF32 off) and bf16 (the tensor-core kernel), a narrow CSP graph
     (8-channel slots, a route concat) whose last tile is ragged, and a
     region without the stem whose 1024-channel step takes narrowed
     weight passes; each check prints its error and the share of elements
     that differ;
  4. yolov4-608 serving at b=8 in bf16 through Network.submit_detect_device
     and device_out_to_dets, with the kernel's launch count rising on
     every request; one request uint8 (divided by 255 on the card) and
     one of its f32 copy divided on the host, whose served triples must
     be bitwise equal; during one request every launch of the one-pass
     conv epilogue (one per conv served outside the region kernel, its
     count reset just before) held to its plain version on the same f32
     sum (bitwise for linear, leaky, relu and logistic, one ulp for the
     others, with the share of elements that differ), its time in a
     traced request beside the plain version's and the byte bound, and
     its rate from HBM per kind of map; one f32 request against the same
     network with the plain region; bf16 img/s (median and spread of 3
     windows of 20 requests after 30 untimed ones); at b=8, the serving
     shape, the bf16 kernel held to its plain version (one ulp, with the
     share of elements that differ), its time by CUDA events and by
     torch.profiler, the plain
     version's, the multiply-adds it executes (halo and padding included)
     beside the useful ones, its bound, and, for context only, the same
     nine steps as cuDNN's native bf16 convs with torch epilogues one
     layer at a time (a route the port never takes); a profile of one
     request;
  5. the int8 GEMM against its plain version: exactly equal with unit
     scales where |acc| < 2^24 (a ragged shape and a yolov4 3x3 shape),
     and with real scales at a yolov4 1x1 and a 3x3 stride-2 shape; the
     implicit-GEMM int8_conv against its plain version (explicit im2col)
     at yolov4's 1x1, 3x3/1, 3x3/2, a 19x19 3x3 with C = 1024 and a
     ragged M, f32 and bf16 out, with and without leaky: bitwise (the
     sums are exact and the epilogue is the same rounded ops);
  6. int8 serving of yolov4-608 at b=8, bf16 (Network.from_cfg(int8=True)):
     one dynamic request (+90 launches: layer 23 stays in floating point
     inside the region), calibrate_int8 on 4 frames, save and load the
     calibration into a second network, calibrated requests (+91 each,
     one uint8); during one calibrated request every quantized conv's
     bf16 output from the kernel against the plain version on the same
     int8 operands, bitwise, and no explicit im2col on the card; the
     kernel's device time over one request (profiler, CUDA graph) beside
     torch._int_mm's on the same operands and the bound; int8 img/s beside
     the bf16 rate of phase 4; a profile of one request;
  7. a JSON line of the kernels, then {"ok": true, "device": ...} last
     (printed after phase 17);
  8. training (train/step, train/trainer), which launches neither kernel,
     as in the JAX package:
     (a) parity on the card: the narrow CSP + SPP graph (TRAIN_CSP_CFG,
         64 px) and yolov4 at 128 px, burn_in 0, two steps of accum 2 on
         seeded batches, f32 with TF32 off, held to the port's own CPU run
         (updates and rolling statistics; yolov4's updates within three
         times what a 1e-7 change of the input moves the card's own run:
         the graph is chaotic in training); one bf16 step finite and close
         to the f32 step (loss within 1%, updates' cosine >= 0.99);
     (b) full width: `data/synth` writes 128 images, `train_detector`
         trains yolov4-608 at its published batch=64, subdivisions=8,
         mosaic, bf16 (act16), for 5 iterations: the first on the 608
         batch already in flight, then the 896 bucket that multi-scale
         forces while the loss is unset; the bucket, s/iter and img/s
         over the 896 iterations after the profiled third, each loss, the
         peak memory, the loader's rate beside the step's, a profile of
         the third iteration (its CUDA activity: device busy share, top
         kernels); finite
         losses, nonzero batches, non-empty truths,
         moved rolling statistics, nonzero momentum buffers and no kernel
         launch are required;
     (c) train to serve: the saved .weights load through
         Network.from_cfg(compute_dtype=bf16) and serve one request, the
         region kernel's count rising by one;
  9. validation (eval/map, the CLI, in-training mAP), at full width:
     (a) yolov3, yolov3-spp, yolov3-tiny and yolov4-tiny at 416 px, b=8:
         one bf16 request each, and one f32 request through the kernel
         against the plain region on probe params (equal kept sets once
         slots are matched by box); each cfg's region launches;
     (b) yolov4-608 `-mode valid` through the CLI's main over 32 synth
         images (a cut: synthetic images, and probe weights written as
         .weights whose objectness threshold .005 sits in a gap of the
         whole set's logits, 24 candidates an image and head, since at
         random init all 22,743 pass and the host NMS never ends): one
         region launch a batch of 8, the same net through the plain
         region giving the same MapResult; the mAP, the prediction rate
         and the whole call's rate, and a bf16 network's beside them;
     (c) the same with -int8 -int8_calib 4 -calib_file: 91 int8 launches
         a batch;
     (d) DetectorTrainer.evaluate_map (f32, batch 4) over 8 of the
         images, before and after one training iteration: 2 region
         launches a call, a finite mAP, the time of each call;
 10. the video pipeline through the CLI's main (apps/cli, apps/tracker,
     apps/geo, apps/visualize, data/video), yolov4-608 f32 (the CLI's
     default) on 1280x720 4:2:0 y4m clips at 30 fps that the phase writes
     (moving rectangles over a textured background), probe weights whose
     threshold .25 sits in a gap of the clip's objectness logits:
     (a) -mode video, tracking, the device path: the plain path
         (fuse_regions="plain", driven through the same CLI), then the
         kernel path at -pipeline_depth 2 and 1, one FFMA region launch a
         frame, each frame's detections (matched by box, rtol 1e-4) and
         track labels and statuses equal to the plain path's;
     (b) -int8 with a calibration file written first: 91 int8 launches a
         frame, finite detections;
     (c) -mode multi-video, two cameras, -letter_box, a P1 parking lot and
         a HANDOVER zone per camera: one region launch a frame set, the
         card's letterbox equal to the CPU's (within 2e-6);
     (d) -mode image on a 1280x720 PNG: det_still.png written and read
         back at 1280x720;
     (e) -save_output with cv2 blocked raises before any work;
     frames (frame sets) a second from the first to the last finalize,
     the median proc time, a synchronised frame split (decode, resize,
     serve, copy back, track, draw) and one profiled frame's device busy
     share.

 11. Gaussian YOLOv3 (`model_zoo.gaussian_yolov3_cfg`, darknet53 + FPN,
     107 layers, 75 convs, three [Gaussian_yolo] heads) at 512 px and 10
     classes, the published Gaussian_yolov3_BDD.cfg's input and class
     count:
     (a) bf16 requests at b=8, one tensor-core region launch each; one
         f32 request through the FFMA kernel against the plain region on
         probe params (kept sets equal once slots are matched by box), and
         the host path's detections and Detection.uc equal (rtol 1e-4);
         bf16 img/s (3 windows of 20 requests after 30 untimed);
     (b) int8 (63 quantized convs): a dynamic request (62 int8 launches:
         layer 12 stays in floating point inside the region), 4
         calibration frames, a calibrated request (63) with every
         quantized conv bitwise equal to the plain version; int8 img/s;
     (c) Network.resize of a network built at 416 from a .weights file to
         512, then to 608: each serves a triple bitwise equal to a network
         built at that size from the file, one region launch on the new
         plan;
     (d) training: the narrow Gaussian graph (GAUSSIAN_TRAIN_CFG) on the
         card against the port's CPU run in phase 8 (a)'s form (chaotic:
         the yardstick bound), then train_detector at batch=64,
         subdivisions=8 on synth images for 2 iterations: finite losses
         and uc_loss, moved rolling statistics, nonzero momentum buffers,
         no kernel launch; s/iter, img/s, peak memory;
     (e) `-mode valid` through the CLI over 16 synth images, f32, batch 8:
         one region launch a batch, a MapResult equal to the plain path's,
         the prediction rate.

 12. YOLOv1 (pjreddie's yolov1.cfg, written out here as `yolov1_cfg`: 24
     convs, 4 maxpools, [local] 3x3/256, [dropout] .5, [connected] 1715
     and [detection], 197,328,243 params) at 448 px and the rare layer
     kinds:
     (a) serving at b=8 on random weights: f32 heads on the card against
         the port's CPU run (1e-4 of the scale), bf16 heads finite and
         within V1_TOL_BF16 of f32, the [detection] decode on the card
         against the CPU's, detect_batch's eight empty lists and the
         device path's ValueError (no [yolo] head), no kernel launch (no
         region is planned); bf16 img/s (3 windows of 20 requests);
     (b) int8: 22 quantized convs, 22 launches a dynamic and a
         calibrated request, every quantized conv bitwise equal to the
         plain version; int8 img/s;
     (c) training: the narrow YOLOv1 (NARROW_V1_CFG) on the card against
         the port's CPU run in phase 8 (a)'s form, then train_detector at
         batch=64, subdivisions=8, bf16 on synth images for one epoch of
         2 iterations, the dropout masks drawn from the trainer's
         generator on the card: finite losses, moved rolling statistics,
         nonzero momentum (the [local] and [connected] weights among
         them), no kernel launch; s/iter, img/s, peak memory; the saved
         .weights serve heads equal to the trained params folded;
     (d) the rare kinds (RARE_KINDS_CFG: reorg3d both ways, reorg_old,
         reverse upsample, an SE block, scale_wh, maxpool_depth,
         antialiased convs and maxpool read back by routes, [batchnorm];
         RARE_COST_CFG: [crop], dropblock, a 2x2 antialiased conv, a
         [cost] head): f32 on the card through the region kernel (one
         launch a request) against the plain region and the CPU, a
         training step of each against the CPU, and an int8 network whose
         antialiased conv quantizes, its launch bitwise equal to the plain
         version.

 13. the CLI's remaining flags, region_int8 and the training upload
     (`--only cli`; its own timing line), yolov4-608:
     (a) `-mode bench` through the CLI's main at b=8 without training:
         its JSON line (bench.py's keys, no vs_baseline, the card named),
         positive rates, 1 region and 91 int8 launches an int8 request, 1
         region launch a bf16 request;
     (b) region_int8, calibrated, b=8: 107 int8 launches and no region
         launch a request, every launch bitwise equal to the plain
         version, the triple and kept set equal to the plain path's; the
         16 padded convs' kernel time; region_int8, int8 and bf16 img/s;
     (c) `-benchmark_layers 1 -mode valid` (f32, 8 synth images, probe
         weights): a row for the region and every conv after it, TOTAL
         within 10% of the trace's device time, the region row's kernel
         within 10% of its CUDA-event time (f32 and bf16), the top ten
         rows; the bf16 report; the request rate with the profiler ranges
         and with them stubbed out;
     (d) the debug modes: the same triples at levels 1 and 2, a NaN
         planted in layer 25 named in serving and in layer 2 of a
         training step, `-mode valid -dbg_sync 2` printing the same
         report;
     (e) training at batch 64, subdivisions 8, bf16/act16: the first step
         from the f32 batch and from its bf16 cast through the pinned
         staging buffers bitwise equal (deterministic cuDNN); an
         iteration's upload bytes, as the uploaders count them (halved),
         and the pinned copies a trace of the uploads keeps (phase 8
         gives the end-to-end rate);
     (f) `-mode train -show_imgs` on a narrow cfg: three PNGs a batch.
 14. the serving artifact, the C ABI twin and the walkthrough twins
     (`--only export`; its own timing line), yolov4-608 at b=8 on probe
     weights whose threshold .25 sits in a gap of the bf16 heads' logits:
     (a) bf16: Network.export_serving, its seconds and bytes; the
         artifact reloaded here serves eager submit_detect_device's
         triple bitwise; a child process that imports only
         darknet_tpu_torch loads it and serves the same frames: 1 region
         and 0 int8 launches a request (its own counters), kept sets
         equal to eager's once slots are matched by box, every value
         within one bf16 ulp of its part's scale;
     (b) calibrated int8: the same, with 1 region and 91 int8 launches a
         request, and 1 region node and 91 int8_conv nodes in the
         exported graph;
     (c) the artifact's img/s against eager's in 1 window of 10
         requests each way, in turns, one request each way in a trace,
         and the host time of one torch.ops int8_conv call against its
         binding's;
     (d) the C ABI twin built with gcc and native/capi/demo.c linked
         against it on the card (DTPU_DEVICE=cuda), the fixture
         yolov3-tiny cfg: test_capi's lines;
     (e) the walkthrough twins 01-05 on the card at their test sizes (01
         for 3 of its test's 12 iterations; 05 on a mesh naming the card
         twice: its ranks' weights equal); (d) and (e) run beside (a) and
         (b) and end before (c).
     The kernels line gives the children's launches
     (`phase14_export_bf16_child`, `phase14_export_int8_child`).
 15. data parallelism (`--only parallel`; its own timing line),
     yolov4-608:
     (a) training at global batch 8, subdivisions 2, f32 (TF32 off), from
         the seed's init: the step without a mesh; an NCCL world of one,
         bitwise that step (deterministic algorithms); two gloo ranks
         sharing the card (`parallel.multihost.spawn`), each on its block
         of the batch: bitwise equal to each other, held to the
         one-process step in phase 8 (a)'s form for a chaotic graph; the
         step times of both and the all-reduces' share of a profiled
         rank step;
     (b) b=8 served in bf16, calibrated int8 and f32 on a mesh naming the
         card twice: the region kernel at the blocks' shape (b=4) held to
         its plain version as phase 1 holds it; 2 region launches a
         request (and 2 x 91 int8, each bitwise its plain version on its
         own operands), the triple bitwise each block's served alone, a
         block of 4 through the f32 kernel keeping the plain regions'
         set, and the kept set
         the unsharded request's once slots are matched by box (f32 and
         int8: equal; bf16, where cuDNN picks its algorithms by batch
         size: every entry that differs traced to a threshold, overlap
         or score-order decision of NMS that the two requests' pre-NMS
         values take the other way, the score noise under bf16's own
         against f32); the mesh's img/s against
         the unsharded (bf16, int8), 2 windows of 10 requests each way in
         turns;
     (c) `-mode valid -num_chips 2` through the CLI's main over 8 synth
         images on probe weights, the mesh's devices named cuda:0 twice
         (the card's one): 2 region launches a batch of 8, the one-device
         MapResult.
     The kernels line gives the mesh's launches (`phase15_mesh_bf16`,
     `phase15_mesh_int8`, `phase15_mesh_valid`).
 16. model-parallel serving (`--only model_parallel`; its own timing
     line), yolov4-608 b=8 on probe weights, the card named 2 or 4 times,
     every region launch held to `region_plain` on its own input (the
     extended slab) and every int8 launch bitwise to its plain version:
     (a) `parallel.spatial.make_spatial_forward` over sp=2 and (dp=2,
         sp=2) in bf16, f32, calibrated and dynamic int8: dp x sp region
         launches a request, 91 (90 dynamic) int8 a slab; the heads
         against the unsharded forward's (f32 within 1e-4 of each
         spread, bf16 within ROADMAP C3's 2e-2 of the largest, int8
         within the unsharded int8's own gap to f32);
     (b) `parallel.tensor.make_tp_forward` over tp=2 and (dp=2, tp=2) in
         f32, bf16 and calibrated int8: no region launch, 2 x the
         sharded plus the replicated int8 convs a block; the heads
         against the unsharded forward without regions;
     (c) `parallel.pipeline.PipelineForward` over 2 and 4 stages with 2
         and 4 micro-batches in bf16 and calibrated int8: a region
         launch and 91 int8 a micro-batch;
     (d) the Network on {"dp": 2, "sp": 2} in f32, bf16 and calibrated
         int8: kept sets against the unsharded request's, every
         difference traced to the decision that flipped;
     (e) dynamic int8 on a dp=2 mesh: every conv quantized with the
         whole batch's max|x|, kept differences traced;
     (f) bf16 img/s of the sp mesh (whole requests), tp (dp=2, tp=2) and
         the pipeline (4 stages, 4 micro-batches) against unsharded, 2
         windows of 10 each way in turns; one profiled request each way
         (device busy share, device events a request).
     The kernels line gives their launches (`phase16_spatial_bf16`,
     `phase16_spatial_int8`, `phase16_tp_int8`, `phase16_pipeline_bf16`,
     `phase16_pipeline_int8`, `phase16_mesh_sp`).
 17. model-parallel training (`--only model_parallel_train`; its own
     timing line), yolov4-608 at global batch 8, subdivisions 2, f32
     with TF32 off, from the seed's init (phase 15 (a)'s), the card named
     2, 4 or 8 times; every sharded step taken from that state and held
     to the step without a mesh in phase 8 (a)'s form for a chaotic
     graph (updates, rolling statistics and momentum within ten times
     that step's own response to a 1e-7 input change, capped at 30% of
     the update; the costs within 1e-4), its peak memory beside:
     (a) `parallel.pipeline.PipelineTrain` over 2 and 4 stages with 2 and
         4 micro-batches, against the step of the same accum;
     (b) `parallel.tensor.make_tp_train_step` over tp=2 and (dp=2, tp=2);
     (c) `parallel.spatial.make_spatial_train_step` over sp=2 and (dp=2,
         sp=2); one bf16/act16 step on (dp=2, sp=2) against the
         unsharded bf16/act16 step, the costs within 1%: on
         yolov4-tiny-608 (same batch) the updates and rolling statistics
         within that step's own distance from f32 and 30% of the update;
         on yolov4 the distances printed, not held (at init two correct
         bf16 steps part by the update's own size there);
     (d) the (dp=2, sp=2, tp=2) step, and `darknet_tpu_torch.dryrun.
         dryrun_multichip(8)` (yolov4-tiny-128);
     (e) the 4x4 pipeline: step ms against the step without a mesh, 2
         steps each way in turns; one profiled step each way (device busy and idle share,
         device events, host kernel launches; the step without a mesh
         profiled once an accum); the peak memory of (a)-(d);
     (f) the params that the 4-stage pipeline (2 micro-batches) and
         (dp=2, tp=2) trained, folded and served b=8 through the
         Network: bf16 (1 region launch, held to `region_plain` as phase
         16 holds it) and calibrated int8 (91 launches, each bitwise its
         plain version); the heads within three times the step's own
         response to a 1e-7 input change (read on the f32 heads) plus
         the network's own distance from f32 of the heads served from
         the step without a mesh's params, each bound below the step's
         own move of the heads (the init params' heads against the
         trained ones).
     The kernels line gives the (dp=2, tp=2) params' launches
     (`phase17_trained_bf16`, `phase17_trained_int8`).
 18. the model-parallel meshes across processes (`--only
     model_parallel_mp`; its own timing line): gloo ranks sharing the
     card (`parallel.multihost.spawn`, `parallel.mesh.world_mesh`), one
     world of 4 ranks; every rank counts its own launches
     and holds each of them to its plain version (region: `region_plain`
     on its own input; int8: bitwise):
     (a) yolov4-608 b=8 on phase 16's probe weights, bf16 and calibrated
         int8, over (dp=2, sp=2) through the Network's
         `submit_detect_device(mesh=)` (each rank passes its dp block;
         decode, top-k and NMS on each rank), (dp=2, tp=2) through
         `make_tp_forward` and a
         4-stage `PipelineForward` with 4 micro-batches: the launches by
         rank (a region launch a slab; none under tp; one a micro-batch
         on stage 0's rank), the world's launches the one-process mesh's
         (sp, pipeline), and the served triples (sp, gathered over dp)
         held bitwise to phase 16's one-process mesh of the same shape on
         rank 0, the heads (tp, pipeline) bitwise or else within phase
         16's bounds;
     (b) phase 15's init at global batch 8, subdivisions 2, f32 (TF32
         off, cuDNN's deterministic algorithms): one step each of the
         4-stage pipeline with 4 micro-batches, (dp=2, tp=2) and (dp=2,
         sp=2), held to phase 17's one-process step of the same mesh (bitwise, or else in phase 8
         (a)'s form against the step without a mesh's response to a 1e-7
         input change), every rank's cost the same; the pipeline's params
         gathered and served once in bf16 (its region launch held);
     (c) the sp and pipeline bf16 requests of (a) and the pipeline's
         step against the one-process mesh, 2 each way in turns (rank 0's ms; the
         one-process run on rank 0 alone), the last world run with the
         host time in the exchanges clocked (the point-to-point and
         collective calls of torch.distributed and the waits for posted
         sends); the other steps' first ms against the one-process
         mesh's beside (b).  Printed only.
     The kernels line gives the launches by rank (`phase18_mp_sp_bf16`,
     `phase18_mp_sp_int8`, `phase18_mp_pipeline_bf16`).

`python3 chip_smoke.py --only video` (or `--only gaussian`, `--only v1`,
`--only cli`, `--only export`, `--only parallel`, `--only
model_parallel`, `--only model_parallel_train`, `--only
model_parallel_mp`) builds the kernels and runs phase 10 (11, 12, 13,
14, 15, 16, 17, 18) alone (its last line is then not the contract's).

Weights are random (numpy, seed 0); the training images are drawn from a
seed into a temporary directory; no file outside the checkout is read.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

# f32 check: FFMA and cuDNN (TF32 off) sum in different orders, so the
# kernel agrees with the plain version to ~1e-6 of the output's scale;
# 1e-4 leaves room for depth.  bf16: the tensor-core kernel and the plain
# version (exact bf16 products summed in f32, f32 bias, one rounding)
# each round a conv's sum once; sums in another order land on the other
# side of a rounding boundary at times, so an element differs by one bf16
# ulp at most (2^-7 of the scale).  At 608 px, b=8, 0.52% of the
# elements differ and the largest difference is 5.5e-3 of the scale
# (chip_region_tiles.py on an H100); phase 4 checks that shape again.
TOL_F32 = 1e-4
TOL_BF16 = 2.0 ** -7
SERVE_BATCH = 8
SERVE_PX = 608
RATE_WARMUP = 30         # untimed requests before the first window
RATE_REQUESTS = 20       # requests per timed window (~1 s at b=8)
RATE_WINDOWS = 3
CHECKS = ((608, 2), (416, 1))        # (px, batch) of the yolov4 checks
DEVICE = "cuda"
KERNELS = ("fused_region", "int8_gemm")
# int8 GEMM checks (name, M, K, N) at b=8 of yolov4-608: unit scales and
# zero bias where |acc| < 2^24 (the f32 output is the exact sum), then
# real scales at the serving path's shapes
INT8_EXACT = (("ragged", 1000, 96, 200),
              ("yolov4-608 L60 3x3", 8 * 38 * 38, 9 * 256, 256))
INT8_REAL = (("yolov4-608 L54 1x1", 8 * 76 * 76, 256, 256),
             ("yolov4-608 L55 3x3/2", 8 * 38 * 38, 9 * 256, 512))
# int8_conv checks (name, B, H, C, N, size, stride) against the plain
# version, bitwise, at f32 and bf16 out
INT8_CONV = (("yolov4-608 1x1", 8, 76, 256, 256, 1, 1),
             ("yolov4-608 3x3/1", 8, 38, 256, 256, 3, 1),
             ("yolov4-608 3x3/2", 8, 76, 256, 512, 3, 2),
             ("yolov4-608 3x3 19x19 C=1024", 8, 19, 1024, 512, 3, 1),
             ("ragged M", 3, 13, 128, 256, 3, 1))
INT8_CONVS = 91          # quantized convs of yolov4 (min(c, n) >= 128)
PEAK_INT8 = 1979e12      # H100 SXM dense int8 tensor-core op/s
PEAK_BF16 = 989e12       # dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12     # HBM3 bytes/s
INT8_CALIB_FRAMES = 4
# Gaussian YOLOv3 (phase 11): the input size and class count of the
# published Gaussian_yolov3_BDD.cfg; 63 of its 75 convs quantize (the
# three head convs excluded); resize 416 -> 512 -> 608
GAUSS_PX = 512
GAUSS_CLASSES = 10
GAUSS_INT8_CONVS = 63
GAUSS_RESIZE = (416, 512, 608)
GAUSS_TRAIN_IMAGES = 128
GAUSS_TRAIN_ITERS = 2
GAUSS_VALID_IMAGES = 16
# YOLOv1 (phase 12): 448 px, the serving batch; 22 of its 24 convs
# quantize (min(c, n) >= 128: not the 3 -> 64 and 64 -> 192 openers).
# bf16 rounds every layer's output (2^-9 relative), over 28 layers about
# 1e-2 of the heads' scale: V1_TOL_BF16 bounds the bf16 heads against
# the f32 heads.  Training at the published batch=64, subdivisions=8 on
# V1_TRAIN_IMAGES synth images (VOC's 20 classes; synth labels use 0-3),
# one epoch of V1_TRAIN_ITERS iterations: this fork counts max_iter in
# epochs (max_epoch, default 1) and ignores the cfg's max_batches.
V1_PX = 448
V1_INT8_CONVS = 22
V1_TOL_BF16 = 5e-2
V1_CLASSES = 20
V1_TRAIN_ITERS = 2
V1_TRAIN_IMAGES = 64 * V1_TRAIN_ITERS
# batch seeds of the parity steps on the card: no leaky input of the
# narrow YOLOv1's micro-batches, nor of RARE_COST_CFG's, lies within 1e-6
# of its layer's largest from 0 (the CPU tests' kink check); the larger
# RARE_KINDS_CFG has such inputs in every batch, and its bound is the
# yardstick's, as for the narrow CSP graph
V1_PARITY_SEED = 3
RARE_PARITY_SEED = 24
# training: parity on the card (batch, steps, accum; the narrow graph's
# updates within TOL_TRAIN of the largest update, or YARDSTICK times the
# card's own response to a 1e-7 input change) and the full-width run
TRAIN_PARITY_BATCH = 4
TRAIN_PARITY_STEPS = 2
TRAIN_ACCUM = 2
TOL_TRAIN = 2e-3
YARDSTICK = 3.0
YARDSTICK_V4 = 10.0       # yolov4's bound: this times its yardstick, capped
CAP = 0.3                 # at CAP of the update (see the CPU step test)
TRAIN_IMAGES = 128
TRAIN_IMAGE_PX = ((416, 640), (416, 640))   # synth image sizes (w, h)
TRAIN_ITERS = 5
TRAIN_LOADER_PROCS = 7
TRAIN_PROFILED_ITER = 3    # the second on the 896 bucket; the end-to-end
                           # window is the iterations after it
# validation (phase 9): the zoo at ZOO_PX, b=8 (BN scale of its lively
# params: the deep leaky graphs saturate at 1.5), then yolov4-608 over a
# synth set through the CLI at its batch of 8, and in-training mAP
ZOO = {"yolov3": 1.2, "yolov3-spp": 1.2, "yolov3-tiny": 1.5,
       "yolov4-tiny": 1.5}
ZOO_PX = 416
VALID_IMAGES = 32
VALID_BATCH = 8
VALID_THRESH = 0.005      # validate_detector's detection threshold
VALID_PASS = 24           # objectness candidates an image and head over it
VALID_CLASSES = 80        # the published head width; synth labels use 0-3
MAP_VALID_IMAGES = 8
MAP_BATCH = 4             # DetectorTrainer.evaluate_map's batch
# video (phase 10): the CLI's streaming modes on 1280x720 4:2:0 clips at
# 30 fps, probe weights whose threshold passes VIDEO_PASS candidates a
# frame and head; the card's letterbox held to the CPU's at the CPU
# test's tolerance (tests/test_torch_apps_io.py)
VIDEO_W, VIDEO_H, VIDEO_FPS = 1280, 720, 30
VIDEO_FRAMES = 16
VIDEO_SETS = 8            # multi-video frame sets (two cameras)
VIDEO_THRESH = 0.25
VIDEO_PASS = 8
VIDEO_SPLIT_FRAMES = VIDEO_FRAMES   # the clip; its first frame is left out of the medians
LETTERBOX_TOL = 2e-6

NARROW_CSP_CFG = """[net]
width=200
height=200
channels=3
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[route]
layers = -2
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish
[shortcut]
from=-3
activation=linear
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[route]
layers = -1,-7
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[convolutional]
filters=12
size=1
stride=1
pad=1
activation=linear
[yolo]
mask=0
num=1
classes=7
anchors=16,16
"""
# a region without the stem (its input is conv 0's 16 channels, loaded
# element by element) whose 1024-channel step fits shared memory only
# with narrowed weight passes
# training parity graph: a narrow CSP block, a strided maxpool, an SPP
# block (stride-1 maxpools 5/9/13), an upsample route and a yolo head
TRAIN_CSP_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[route]
layers = -2
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=mish
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=mish
[shortcut]
from=-2
activation=linear
[route]
layers = -1,-5
[maxpool]
size=2
stride=2
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[maxpool]
stride=1
size=5
[route]
layers=-2
[maxpool]
stride=1
size=9
[route]
layers=-4
[maxpool]
stride=1
size=13
[route]
layers=-1,-3,-5,-6
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[upsample]
stride=2
[route]
layers=-1,-11
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
filters=27
size=1
stride=1
pad=1
activation=linear
[yolo]
mask=0,1,2
anchors=8,8, 16,20, 28,24
classes=4
num=3
jitter=.3
ignore_thresh=.7
truth_thresh=1
scale_x_y=1.05
iou_thresh=0.213
iou_normalizer=0.07
cls_normalizer=1.0
iou_loss=ciou
max_delta=5
"""

# the narrow Gaussian graph of phase 11 (d) and the CPU tests: a
# residual, an upsample + route and two [Gaussian_yolo] heads, BN + leaky
GAUSSIAN_TRAIN_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[shortcut]
from=-3
activation=linear
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=32
size=3
stride=2
pad=1
activation=leaky
[convolutional]
filters=39
size=1
stride=1
pad=1
activation=linear
[Gaussian_yolo]
mask=3,4,5
anchors=6,8, 10,14, 16,20, 24,22, 34,30, 52,48
classes=4
num=6
jitter=.3
ignore_thresh=.7
truth_thresh=1
iou_loss=mse
uc_normalizer=1.0
[route]
layers=-3
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[upsample]
stride=2
[route]
layers=-1,-8
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
filters=39
size=1
stride=1
pad=1
activation=linear
[Gaussian_yolo]
mask=0,1,2
anchors=6,8, 10,14, 16,20, 24,22, 34,30, 52,48
classes=4
num=6
jitter=.3
ignore_thresh=.7
truth_thresh=1
scale_x_y=1.05
iou_thresh=0.213
iou_normalizer=0.5
iou_loss=giou
uc_normalizer=0.5
"""

# YOLOv1 (phase 12): pjreddie/darknet cfg/yolov1.cfg, its sections in
# order with its values (the training batch=64, subdivisions=8): 24 convs
# (filters, size, stride; BN + leaky, pad=1) and 4 maxpools ("M", 2/2),
# then [local] 3x3/256, [dropout] .5, [connected] 1715 and [detection]
YOLOV1_LAYERS = ((64, 7, 2), "M", (192, 3, 1), "M",
                 (128, 1, 1), (256, 3, 1), (256, 1, 1), (512, 3, 1), "M",
                 *((256, 1, 1), (512, 3, 1)) * 4, (512, 1, 1), (1024, 3, 1),
                 "M", *((512, 1, 1), (1024, 3, 1)) * 2,
                 (1024, 3, 1), (1024, 3, 2), (1024, 3, 1), (1024, 3, 1))
YOLOV1_HEAD = """[local]
size=3
stride=1
pad=1
filters=256
activation=leaky
[dropout]
probability=.5
[connected]
output= 1715
activation=linear
[detection]
classes=20
coords=4
rescore=1
side=7
num=3
softmax=0
sqrt=1
jitter=.2
object_scale=1
noobject_scale=.5
class_scale=1
coord_scale=5
"""


def yolov1_cfg(px: int = 448) -> str:
    """yolov1.cfg at px (448 published)."""
    s = (f"[net]\nbatch=64\nsubdivisions=8\nheight={px}\nwidth={px}\n"
         f"channels=3\nmomentum=0.9\ndecay=0.0005\nsaturation=1.5\n"
         f"exposure=1.5\nhue=.1\nlearning_rate=0.0005\npolicy=steps\n"
         f"steps=200,400,600,20000,30000\nscales=2.5,2,2,.1,.1\n"
         f"max_batches = 40000\n")
    for spec in YOLOV1_LAYERS:
        if spec == "M":
            s += "[maxpool]\nsize=2\nstride=2\n"
        else:
            n, size, stride = spec
            s += (f"[convolutional]\nbatch_normalize=1\nfilters={n}\n"
                  f"size={size}\nstride={stride}\npad=1\n"
                  f"activation=leaky\n")
    return s + YOLOV1_HEAD


# the narrow YOLOv1 of phase 12 (c) and the CPU tests: conv s2, maxpool,
# conv, a stride-2 conv, [local] 3x3, [dropout], [connected] with BN,
# [connected], [detection] with sqrt and rescore (side 4, 2 boxes, 3
# classes), 64 px
NARROW_V1_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky
[maxpool]
size=2
stride=2
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky
[maxpool]
size=2
stride=2
[local]
size=3
stride=1
pad=1
filters=8
activation=leaky
[dropout]
probability=.5
[connected]
batch_normalize=1
output=64
activation=leaky
[connected]
output=208
activation=linear
[detection]
classes=3
coords=4
rescore=1
side=4
num=2
softmax=0
sqrt=1
jitter=.2
object_scale=1
noobject_scale=.5
class_scale=1
coord_scale=5
"""

# the rare layer kinds of phase 12 (d) and the CPU tests, 64 px.
# RARE_KINDS_CFG: a region (layers 1-3), an antialiased stride-2
# conv read back by a route (its stride-1 buffer with the blur over its
# front), reverse upsample, reorg3d both ways, reorg_old, an antialiased
# conv that int8 quantizes (128 -> 128), maxpool_depth, an SE block
# (avgpool -> 1x1 -> scale_channels), scale_wh, an antialiased maxpool
# read back by a route, [batchnorm], a [yolo] head.
RARE_KINDS_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
antialiasing=1
activation=leaky
[route]
layers=-1,-2
[upsample]
stride=-2
[reorg3d]
stride=2
[reorg3d]
stride=2
reverse=1
[reorg]
stride=2
[convolutional]
batch_normalize=1
filters=128
size=3
stride=2
pad=1
antialiasing=1
activation=leaky
[maxpool]
maxpool_depth=1
out_channels=32
size=2
stride=1
[avgpool]
[convolutional]
filters=32
size=1
stride=1
pad=0
activation=logistic
[scale_channels]
from=-3
activation=linear
[convolutional]
filters=1
size=1
stride=1
pad=0
activation=logistic
[scale_channels]
from=-2
scale_wh=1
activation=leaky
[maxpool]
size=2
stride=2
antialiasing=1
[batchnorm]
[route]
layers=-2
[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish
[route]
layers=-1,-3
[convolutional]
filters=18
size=1
stride=1
pad=1
activation=linear
[yolo]
mask=0,1,2
anchors=8,8, 16,16, 32,32
classes=1
num=3
max=12
"""

# RARE_COST_CFG: [crop] with flip, a region (layers 1-3), a 2x2-box antialiased
# stride-2 conv, dropblock, and a [cost] head (sse)
RARE_COST_CFG = """[net]
batch=4
subdivisions=1
width=64
height=64
channels=3
learning_rate=0.001
momentum=0.9
decay=0.0005
burn_in=0
[crop]
crop_height=48
crop_width=48
flip=1
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
antialiasing=2
activation=leaky
[dropout]
probability=.2
dropblock=1
dropblock_size_abs=3
[convolutional]
filters=4
size=1
stride=1
pad=1
activation=linear
[cost]
type=sse
"""

WIDE_LAYERS = ((16, 3), (1024, 1), (32, 1))
WIDE_PX = 64


def conv_stack_cfg(px: int, layers) -> str:
    """A cfg of stride-1 convs, (filters, size) each with BN and leaky,
    under a one-class yolo head."""
    s = f"[net]\nwidth={px}\nheight={px}\nchannels=3\n"
    for n, size in layers:
        s += (f"[convolutional]\nbatch_normalize=1\nfilters={n}\n"
              f"size={size}\nstride=1\npad=1\nactivation=leaky\n")
    return s + ("[convolutional]\nfilters=18\nsize=1\nstride=1\npad=1\n"
                "activation=linear\n[yolo]\nmask=0,1,2\nnum=3\nclasses=1\n"
                "anchors=10,10,20,20,30,30\n")


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def quiet_graph(cfg, train=False):
    from darknet_tpu_torch.graph.builder import build_graph

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg, train=train)


PROBE_PASS = 24          # candidates per head that pass the threshold


# the entries of a head's anchor: (the first class entry, objectness, the
# entries that read no input in probe_params, the sigmas)
HEAD_LAYOUT = {"yolo": (5, 4, (2, 3), ()),
               "gaussian_yolo": (9, 8, (4, 6), (1, 3, 5, 7))}
# sigma logits of a Gaussian probe head, one per coordinate (shifted by
# 0.25 an anchor): 1 - mean(sigmoid) rounds to 1 in f32, so the sigmas
# leave every class score where the objectness threshold's gap put it
SIGMA_PROBE_BIAS = (-24.0, -23.0, -22.0, -21.0)


def probe_params(graph, seed=0, obj_bias=None, gains=(30.0, 280.0, 1300.0),
                 bn_scale=1.5):
    """Numpy params (BN folded) for the f32 kernel-vs-plain request.

    At random init yolov4's heads sit at sigmoid(~0), where every score
    ties and the kept set is decided by f32 noise.  Here the trunk runs
    with BN scales `bn_scale`, each head's x/y/obj channels are scaled by
    its gain (yolov4's by default), its w/h and class channels read no
    input (w/h bias 0: anchor-sized boxes; one class per anchor at bias
    +12, the rest at -12), and `obj_bias` (one value per head) places the
    score threshold in a wide gap of the objectness logits, so that no
    decision sits within noise of it.  A [Gaussian_yolo] head (objectness
    at entry 8, classes from 9, mu_w/mu_h at 4/6) gets the same, and its
    sigmas read no input either (SIGMA_PROBE_BIAS), since 1 - mean(sigmas)
    scales its class scores."""
    from darknet_tpu_torch.nn import params as paramlib

    p = paramlib.init_params(graph, seed=seed)
    for d in p:
        if "scales" in d:
            d["scales"] = d["scales"] * np.float32(bn_scale)
    p = paramlib.fuse_conv_batchnorm(graph, p)
    for hi, (l, gain) in enumerate(zip(graph.heads(), gains)):
        cls, obj, still, sigmas = HEAD_LAYOUT[l.kind]
        d = p[l.index - 1]
        w, b = d["w"] * np.float32(gain), np.zeros_like(d["b"])
        e = cls + l.classes
        for a in range(l.n):
            o = a * e
            w[..., [o + k for k in still + sigmas]] = 0.0
            w[..., o + cls:o + e] = 0.0
            b[o + cls:o + e] = -12.0
            b[o + cls + (3 * hi + a) % l.classes] = 12.0
            b[o + obj] = 0.0 if obj_bias is None else obj_bias[hi]
            for k, v in zip(sigmas, SIGMA_PROBE_BIAS):
                b[o + k] = v + 0.25 * a
        d["w"], d["b"] = w, b
    return p


def obj_bias_for(raw_heads, thresh, n_pass=PROBE_PASS, obj=4):
    """Per head: the obj bias that puts logit(thresh) midway between the
    n_pass-th and the next largest objectness logit (entry `obj` of each
    of the head's three anchors: 4 for [yolo], 8 for [Gaussian_yolo])."""
    import torch

    biases = []
    for h in raw_heads:
        e = h.shape[-1] // 3
        logits = h.reshape(-1, 3, e)[..., obj].flatten().double()
        top = torch.sort(logits, descending=True).values
        k = min(n_pass, len(top) - 1)
        cut = float(top[k - 1] + top[k]) / 2
        biases.append(float(np.log(thresh / (1 - thresh))) - cut)
    return biases


def cuda_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, reps=5) -> float:
    """Device time of fn() without the host's launch time: fn captured
    once in a CUDA graph, the graph replayed `reps` times between CUDA
    events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                             # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, name=None):
    """(device ms, kernels) of one fn() call in a torch.profiler trace:
    the summed durations of the device events whose name contains `name`
    (all kernels when None: the trace's first event, a one-byte copy, is
    no kernel).  (None, 0) if the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from darknet_tpu_torch.utils.profiler import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first_device_event()
        fn()
        torch.cuda.synchronize()
    dev = device_events(prof.events())
    if not dev:
        return None, 0
    hit = [e for e in dev if (name in e.name if name is not None
                              else not e.name.startswith("Memcpy"))]
    return sum(e.time_range.elapsed_us() for e in hit) / 1e3, len(hit)


def trace_summary(fn, label, card, n=8, cpu=True):
    """fn() once in a profiler trace: device busy time, the idle share of
    the device window, and the kernels that take the most time.
    cpu=False records the CUDA activity alone and reads the trace's raw
    events (a training iteration's event tree takes longer to build than
    the iteration)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from darknet_tpu_torch.utils.profiler import device_events

    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels and copies, not the profiler ranges' device spans
    if cpu:
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in device_events(prof.events())]
    else:
        from torch.autograd import DeviceType

        dev = [(e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    if not dev:
        print(f"{label} profile: no device events", flush=True)
        return None
    busy = sum(b - a for _n, a, b in dev) / 1e3
    span = (max(b for _n, _a, b in dev) - min(a for _n, a, _b in dev)) / 1e3
    by = collections.Counter()
    for name, a, b in dev:
        by[name[:60]] += (b - a) / 1e3
    top = "; ".join(f"{k} {v:.3f}" for k, v in by.most_common(n))
    print(f"{label} profile: {len(dev)} device events, busy "
          f"{busy:.3f} ms of a {span:.3f} ms window (idle "
          f"{100 * (1 - busy / span):.1f}%); top ms: {top} [{card}]",
          flush=True)
    return busy, span


def top_kernels(net, frame, label, card, n=8):
    """One request in a profiler trace (trace_summary)."""
    import torch

    def request():
        net.device_out_to_dets(*net.submit_detect_device(frame))
    request()
    torch.cuda.synchronize()
    trace_summary(request, f"{label} request", card, n)


def region_bound(sub, x, ws, bs, out_shape):
    """(least ms, "operations" or "bytes") of the region prefix kernel: its
    useful FLOPs at the bf16 tensor-core peak, or its input, weights,
    biases and bf16 output read or written once at the memory rate."""
    flops = sum(2 * x.shape[0] * sub.h * 2 * sub.w2 * st.kh * st.kw
                * sum(st.srcs_c) * st.n for st in sub.conv_steps)
    nbytes = (x.numel() * 2 + sum(w.numel() * 2 for w in ws)
              + sum(b.numel() * 4 for b in bs) + int(np.prod(out_shape)) * 2)
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    print(f"region prefix: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB: "
          f"bound {1e3 * max(t_ops, t_bytes):.4f} ms", flush=True)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                        else "bytes")


def unfused_cudnn(sub, x, wc, bc):
    """The region prefix as cuDNN's native bf16 convs (channels-last; wc:
    OIHW channels-last bf16 weights, bc: bf16 biases), each with a torch
    activation, one layer at a time: the unfused route the fused kernel
    has to beat.  For context only; the port never takes it."""
    import torch
    import torch.nn.functional as F

    from darknet_tpu_torch.ops.activations import apply_activation
    from darknet_tpu_torch.ops.fused_region import IN_SLOT, AddStep
    from darknet_tpu_torch.ops.stem import space_to_depth

    slots = {IN_SLOT: space_to_depth(x).to(torch.bfloat16)}
    wi = 0
    for st in sub.steps:
        if isinstance(st, AddStep):
            slots[st.out_slot] = apply_activation(
                slots[st.a] + slots[st.b], st.act)
            continue
        src = torch.cat([slots[s] for s in st.srcs], dim=-1) \
            if len(st.srcs) > 1 else slots[st.srcs[0]]
        src = src.permute(0, 3, 1, 2)                  # NCHW, channels-last
        pads = (st.pl_, st.kw - 1 - st.pl_, st.pt, st.kh - 1 - st.pt)
        if pads[0] == pads[1] and pads[2] == pads[3]:
            y = F.conv2d(src, wc[wi], bc[wi], padding=(st.pt, st.pl_))
        else:
            src = F.pad(src, pads).contiguous(
                memory_format=torch.channels_last)
            y = F.conv2d(src, wc[wi], bc[wi])
        slots[st.out_slot] = apply_activation(y.permute(0, 2, 3, 1), st.act)
        wi += 1
    return slots[sub.out_slot]


def serve_rate(net, frame, request=None, warmup=RATE_WARMUP,
               windows=RATE_WINDOWS, requests=RATE_REQUESTS):
    """Throughput: whole requests (`request()`; by default the device
    serving program and its detections), host clock around synchronised
    work, `windows` windows of `requests` requests after `warmup`.
    Returns (median img/s, spread (max - min) / median, the rates)."""
    import torch

    def served():
        net.device_out_to_dets(*net.submit_detect_device(frame))
    request = request or served
    for _ in range(warmup):
        request()
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(requests):
            request()
        torch.cuda.synchronize()
        rates.append(requests * SERVE_BATCH / (time.perf_counter() - t0))
    img_s = float(np.median(rates))
    return img_s, (max(rates) - min(rates)) / img_s, rates


def held_to_plain(got, want, tol):
    """(max abs err, scale, share of elements that differ, ok): ok when
    every element is finite and within tol of the plain version's
    scale."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    return err, scale, float((got != want).float().mean()), ok


def check_region(name, graph, batch, dtype, seed):
    """Kernel vs plain version on the graph's first region (its stride-1
    prefix); returns a dict."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    npar = paramlib.fuse_conv_batchnorm(
        graph, paramlib.init_params(graph, seed=seed))
    tp = paramlib.params_to_torch(graph, npar, DEVICE, dtype)
    plans = fr.plan_graph_regions(graph, stem=True)
    plan = plans[min(plans)]
    pre = fr.hybrid_prefix(plan)
    sub = pre[0] if pre is not None else plan
    kp = kfr.kernel_plan(sub, torch.tensor([], dtype=dtype).element_size())
    rng = np.random.default_rng(seed)
    if sub.stem:
        x = rng.uniform(0, 1, (batch, graph.net.h, graph.net.w, 3))
    else:
        x = rng.normal(0, 1, (batch, sub.h, 2 * sub.w2, sub.in_c))
    x = torch.from_numpy(x.astype(np.float32)).to(DEVICE)
    ws, bs = fr.step_weights(sub.steps, tp, dtype)
    want = fr.region_plain(sub, x, ws, bs, compute_dtype=dtype)
    got = kfr.region_call(sub, x, ws, bs, compute_dtype=dtype)
    torch.cuda.synchronize()
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    err, scale, share, ok = held_to_plain(got, want, tol)
    res = {"name": name, "dtype": str(dtype).split(".")[-1],
           "kernel": "tensor cores" if kp.tensor_cores else "ffma",
           "stem": sub.stem, "shape": list(got.shape), "tile": kp.tile,
           "threads": kp.threads,
           "ragged": sub.h % kp.tile != 0 or 2 * sub.w2 % kp.tile != 0,
           "smem_bytes": kp.smem_bytes, "max_abs_err": err, "scale": scale,
           "tol_rel": tol, "differ_share": share, "ok": ok}
    print("check", json.dumps(res), flush=True)
    return res


def phase_kernels():
    import torch

    from darknet_tpu_torch import model_zoo

    checks = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for px, b in CHECKS:
            g = quiet_graph(model_zoo.yolov4_cfg(px, px))
            for dt in (torch.float32, torch.bfloat16):
                checks.append(check_region(f"yolov4-{px}-prefix", g, b, dt,
                                           seed=px))
        g = quiet_graph(NARROW_CSP_CFG)
        for dt in (torch.float32, torch.bfloat16):
            checks.append(check_region("narrow-csp-200", g, 2, dt, seed=3))
        g = quiet_graph(conv_stack_cfg(WIDE_PX, WIDE_LAYERS))
        for dt in (torch.float32, torch.bfloat16):
            checks.append(check_region(f"wide-{WIDE_PX}", g, 2, dt, seed=4))
    require(all(c["ragged"] for c in checks
                if c["name"] == "narrow-csp-200"), "a ragged edge tile")
    require(not any(c["stem"] for c in checks
                    if c["name"] == f"wide-{WIDE_PX}"), "a region without "
            "the stem")
    bad = [c["name"] + "/" + c["dtype"] for c in checks if not c["ok"]]
    require(not bad, f"kernel agrees with its plain version: {bad}")
    return checks


def kept(probs) -> set:
    return set(zip(*np.nonzero(probs.float().cpu().numpy() > 0)))


def bf16_ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (signed
    zeros equal)."""
    import torch

    def key(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (key(a) - key(b)).abs()


def kernel_events(fn, name):
    """Durations in us, in launch order, of the device events whose name
    contains `name` over one fn() call in a torch.profiler trace (after
    one untraced call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from darknet_tpu_torch.utils.profiler import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first_device_event()
        fn()
        torch.cuda.synchronize()
    hit = sorted((e.time_range.start, e.time_range.elapsed_us())
                 for e in device_events(prof.events()) if name in e.name)
    return [us for _start, us in hit]


def check_conv_epilogue(net, frame, card):
    """The one-pass conv epilogue (`ops/cuda/conv_epilogue`) over one
    served request: one launch per conv served outside the region kernel,
    in order, each sum NHWC-contiguous, and each launch held to the plain
    version on the same f32 sum (bitwise for linear, leaky, relu and
    logistic; one bf16 ulp at most for the others, whose arithmetic nvcc
    contracts into FMAs), with the share of elements that differ.  Times:
    the kernel's durations in a traced request (the main path: part of
    each sum is still in L2 from the conv that wrote it), the plain
    version's kernels over the request's sums, and the bound, the
    request's elements at 6 B (f32 read, bf16 written) at 3.35 TB/s; per
    kind of map (shape, activation), the kernel's rate from HBM, a read
    of 256 MB clearing the 50 MB L2 before each of 5 launches."""
    import collections
    import statistics

    import torch

    from darknet_tpu_torch.nn.emit import kernel_conv_indices
    from darknet_tpu_torch.ops.cuda import conv_epilogue as ce

    kernel = kernel_conv_indices(net.graph)
    served = [l for l in net.graph.layers
              if l.kind == "convolutional" and l.index not in kernel]

    def request():
        net.device_out_to_dets(*net.submit_detect_device(frame))

    records, orig = [], ce.conv_epilogue

    def recorded(y, bias, act):
        out = orig(y, bias, act)
        records.append((y, bias, act, out))
        return out

    ce.conv_epilogue = recorded
    try:
        ce.launches = 0
        request()
        launches = ce.launches
    finally:
        ce.conv_epilogue = orig
    require(launches == len(records) == len(served),
            f"one conv_epilogue launch per served conv ({len(served)}), got "
            f"{launches} launches, {len(records)} calls")
    require([(tuple(r[0].shape[1:]), r[2]) for r in records]
            == [((l.out_h, l.out_w, l.n), l.activation) for l in served],
            "the epilogue's launches are the served convs, in order")
    require(all(r[0].is_contiguous() and r[0].dtype == torch.float32
                for r in records), "every sum reaches the kernel as an "
            "NHWC-contiguous f32 tensor")
    stats = collections.defaultdict(lambda: [0, 0, 0])
    err = 0.0
    with torch.inference_mode():
        for y, b, act, out in records:
            want = ce.conv_epilogue_plain(y, b, act)
            d = bf16_ulps(out, want)
            st = stats[act]
            st[0] += d.numel()
            st[1] += int((d > 0).sum())
            st[2] = max(st[2], int(d.max()))
            err = max(err, float((out.float() - want.float()).abs().max()))
    for act, (n, diff, top) in sorted(stats.items()):
        print(f"conv_epilogue {act}: {diff} of {n} elements differ from the "
              f"plain version ({100 * diff / n:.6f}%), at most {top} ulp",
              flush=True)
    bad = {a: st[2] for a, st in stats.items()
           if st[2] > (0 if a in ("linear", "leaky", "relu", "logistic")
                       else 1)}
    require(not bad, f"conv_epilogue within its plain version's tolerance: "
            f"{bad}")

    elements = sum(r[0].numel() for r in records)
    bound = 6 * elements / PEAK_BYTES * 1e3
    sums = [(y, b, act) for y, b, act, _out in records]
    del records
    with torch.inference_mode():
        req_us = kernel_events(request, "conv_epilogue_kernel")
        plain_ms, _n = profiled_ms(
            lambda: [ce.conv_epilogue_plain(*r) for r in sums])
        kinds = {}
        for i, (y, b, act) in enumerate(sums):
            kinds.setdefault((tuple(y.shape), act), []).append(i)
        flush = torch.ones(64 << 20, device=DEVICE)

        def cold(y, b, act):
            for _ in range(5):
                flush.sum()
                ce.conv_epilogue_cuda(y, b, act)

        rows = []
        for (shape, act), idx in kinds.items():
            cold_us = statistics.median(kernel_events(
                lambda: cold(*sums[idx[0]]), "conv_epilogue_kernel"))
            n = sums[idx[0]][0].numel()
            rows.append({"shape": list(shape), "act": act,
                         "convs": len(idx), "elements": n,
                         "served_us": statistics.median(
                             req_us[i] for i in idx)
                         if len(req_us) == len(sums) else None,
                         "cold_us": cold_us,
                         "hbm_pct": 100 * 6 * n / PEAK_BYTES * 1e6 / cold_us})
        del flush
    require(len(req_us) == len(sums), f"{len(sums)} conv_epilogue_kernel "
            f"events in a traced request, got {len(req_us)}")
    ms = sum(req_us) / 1e3
    for r in sorted(rows, key=lambda r: -r["elements"]):
        print(f"conv_epilogue {str(tuple(r['shape'])):>20} {r['act']:>8} "
              f"x{r['convs']:<3} {r['elements'] / 1e6:8.3f} M: served "
              f"{r['served_us']:.2f} us, from HBM {r['cold_us']:.2f} us "
              f"(bound {6 * r['elements'] / PEAK_BYTES * 1e6:.2f} us, "
              f"{r['hbm_pct']:.1f}% of 3.35 TB/s)", flush=True)
    big = ", ".join(f"{r['hbm_pct']:.1f}%" for r in rows
                    if r["elements"] >= 8e6)
    print(f"conv_epilogue over one request's {launches} launches (b="
          f"{frame.shape[0]}, {elements / 1e6:.1f} M elements): kernel "
          f"{ms:.4f} ms in the traced request, plain {plain_ms} ms, bound "
          f"{bound:.4f} ms by bytes ({100 * bound / ms:.1f}%); maps of 8 M "
          f"elements or more from HBM: {big} [{card}]", flush=True)
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "rows": rows}


def phase_serve(card):
    import torch

    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    cfg = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, seed=0, compute_dtype=torch.bfloat16,
                               device=DEVICE)
    rng = np.random.default_rng(0)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = [rng.uniform(0, 1, shape).astype(
        np.float32) for _ in range(3)]
    # one uint8 batch, and its f32 copy divided on the host
    u8 = (frames[1] * 255).astype(np.uint8)
    frames[1:2] = [u8, u8.astype(np.float32) / 255]

    # the main path, counted: reset just before, read just after
    kfr.launches = 0
    counts, results, triples = [], [], []
    for f in frames:
        tb, ov, probs = net.submit_detect_device(f)
        dets = net.device_out_to_dets(tb, ov, probs)
        counts.append(kfr.launches)
        triples.append((tb, ov, probs))
        require(tb.shape[0] == SERVE_BATCH and tb.shape[2] == 4,
                f"boxes shape {tuple(tb.shape)}")
        require(bool(torch.isfinite(tb).all() & torch.isfinite(probs).all()),
                "finite outputs")
        require(len(dets) == SERVE_BATCH, "one detection list per image")
        results.append(sum(len(d) for d in dets))
    launches = kfr.launches
    print("serve requests", len(frames), "launch counts", counts,
          "detections", results, flush=True)
    require(counts == [1, 2, 3, 4],
            f"one region kernel launch per request, got {counts}")
    # uint8 divided by 255 on the card and on the host: both correctly
    # rounded f32 divisions, so the same input and the same triple
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(triples[1], triples[2]))
    same = all(torch.equal(a, b) for a, b in zip(triples[1], triples[2]))
    print(f"uint8 request against its host-divided f32 copy: bitwise equal "
          f"{same} (largest difference {diff})", flush=True)
    require(same, "the uint8 and the f32 requests serve the same triple")
    del triples
    epi = check_conv_epilogue(net, frames[0], card)

    img_s, spread, rates = serve_rate(net, frames[0])

    # the region kernel and its plain version at the serving shape
    plan = net._fwd.region_plans[0]
    sub, _k = fr.hybrid_prefix(plan)
    ws, bs = fr.step_weights(sub.steps, net.params, torch.bfloat16)
    wc = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
          for w in ws]
    bc = [b.to(torch.bfloat16) for b in bs]
    x = torch.from_numpy(frames[0]).to(DEVICE)

    def kernel():
        return kfr.region_call(sub, x, ws, bs, compute_dtype=torch.bfloat16)

    def plain():
        return fr.region_plain(sub, x, ws, bs, compute_dtype=torch.bfloat16)

    with torch.inference_mode():
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        u_ms = cuda_ms(lambda: unfused_cudnn(sub, x, wc, bc))
        u_ms2 = cuda_ms(lambda: unfused_cudnn(sub, x, wc, bc))
        p_ms2, k_ms2 = cuda_ms(plain), cuda_ms(kernel)
        prof_ms, n_prof = profiled_ms(kernel, "region_tc_kernel")
        fwd_ms = cuda_ms(lambda: net._fwd(net.forward_params, x), iters=5)
        out = kernel()
        err, scale, share, ok = held_to_plain(out, plain(), TOL_BF16)
        u_err = float((unfused_cudnn(sub, x, wc, bc).float()
                       - out.float()).abs().max())
    print(f"check region prefix b={SERVE_BATCH} bf16, the serving shape: "
          f"max abs err {err:.4g} at scale {scale:.4g} (tolerance "
          f"{TOL_BF16 * scale:.4g}), {100 * share:.3f}% of the elements "
          f"differ from the plain version", flush=True)
    require(ok, f"the region kernel at b={SERVE_BATCH} agrees with its plain "
            f"version")
    require(n_prof == 1, f"one region_tc_kernel in the trace, got {n_prof}")
    bound, bound_by = region_bound(sub, x, ws, bs, out.shape)
    kp = kfr.kernel_plan(sub, 2)
    executed = kp.macs_per_tile * kp.tiles_y * kp.tiles_x * x.shape[0]
    useful = x.shape[0] * sub.h * 2 * sub.w2 * sum(
        st.kh * st.kw * st.c_tot * st.n for st in sub.conv_steps)
    top_kernels(net, frames[0], "bf16", card)
    print(f"serving yolov4-{SERVE_PX} bf16 b={SERVE_BATCH}: {img_s:.2f} img/s "
          f"median of {RATE_WINDOWS} windows of {RATE_REQUESTS} requests "
          f"({', '.join(f'{r:.2f}' for r in rates)}; spread "
          f"{100 * spread:.2f}%) (forward {fwd_ms:.3f} ms) [{card}]",
          flush=True)
    print(f"region prefix b={SERVE_BATCH} bf16: tensor-core kernel "
          f"{k_ms:.3f} / {k_ms2:.3f} ms by CUDA events, {prof_ms} ms by "
          f"torch.profiler (tile {kp.tile}, {kp.threads} threads, "
          f"{kp.smem_bytes} B shared memory); plain {p_ms:.3f} / "
          f"{p_ms2:.3f} ms; unfused cuDNN bf16 convs + torch epilogues "
          f"{u_ms:.3f} / {u_ms2:.3f} ms (max abs diff to the kernel "
          f"{u_err:.4g}) [{card}]", flush=True)
    print(f"region prefix b={SERVE_BATCH}: {executed / 1e9:.3f} GMAC "
          f"executed (halo and padding included) for {useful / 1e9:.3f} "
          f"GMAC useful ({executed / useful:.4f}x)", flush=True)

    # one f32 request: kernel region against the plain region, on params
    # whose score threshold sits in a gap of the plain path's logits
    g = net.graph
    del net
    x2 = torch.from_numpy(frames[3]).to(DEVICE)

    def f32_net(params, mode):
        return Network(g, paramlib.params_to_torch(g, params, DEVICE,
                                                   torch.float32),
                       device=DEVICE, fuse_regions=mode)

    f32 = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        probe = f32_net(probe_params(g), "plain")
        raw = probe._fwd(probe.params, x2)["raw_heads"]
        npar = probe_params(g, obj_bias=obj_bias_for(raw, 0.25))
        del probe, raw
        for mode in ("hybrid", "plain"):
            f32[mode] = f32_net(npar, mode).submit_detect_device(
                frames[3], thresh=0.25, top_k=256)
    (ka, oa, pa), (kb, ob, pb) = f32["hybrid"], f32["plain"]
    box_err = float((ka - kb).abs().max())
    n_cand = int((ob > 0).sum())
    print(f"f32 request: kept {len(kept(pa))} vs {len(kept(pb))}, "
          f"candidates over thresh {n_cand}, box max err {box_err:.3g}",
          flush=True)
    require(kept(pa) == kept(pb) and box_err <= 1e-4,
            "f32 kernel path keeps what the plain path keeps")
    return {"launches": launches, "img_s": img_s, "ms": k_ms,
            "plain_ms": p_ms, "max_abs_err": err,
            "f32_kept": len(kept(pa)), "bound_ms": bound,
            "bound_by": bound_by, "profiler_ms": prof_ms,
            "unfused_cudnn_ms": u_ms, "epilogue": epi}


def int8_operands(m, k, n, seed, unit):
    """Seeded GEMM operands on the card: (a (M,K), b (N,K), w_scales,
    bias, x_scale); unit scales and zero bias when `unit`."""
    import torch

    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (n, k), dtype=np.int8)
    if unit:
        ws, bias, xs = np.ones(n), np.zeros(n), 1.0
    else:
        ws, bias, xs = rng.uniform(1e-3, 1e-2, n), rng.normal(0, 1, n), 0.0039
    return tuple(torch.from_numpy(np.asarray(t, dt)).to(DEVICE)
                 for t, dt in ((a, np.int8), (b, np.int8),
                               (ws, np.float32), (bias, np.float32),
                               ([xs], np.float32)))


def int8_conv_operands(b, h, c, n, size, stride, seed):
    """Seeded conv operands on the card, darknet padding size // 2:
    ((x_q, w_q, w_scale, bias, x_scale), geometry keywords)."""
    import torch

    from darknet_tpu_torch.ops.conv import darknet_conv_padding

    rng = np.random.default_rng(seed)
    pad = size // 2
    o = (h + 2 * pad - size) // stride + 1
    x_q = rng.integers(-127, 128, (b, h, h, c), dtype=np.int8)
    w_q = rng.integers(-127, 128, (n, size * size * c), dtype=np.int8)
    ws, bias = rng.uniform(1e-3, 1e-2, n), rng.normal(0, 1, n)
    ops = tuple(torch.from_numpy(np.asarray(v, dt)).to(DEVICE)
                for v, dt in ((x_q, np.int8), (w_q, np.int8),
                              (ws, np.float32), (bias, np.float32),
                              ([0.0039], np.float32)))
    kw = {"size": size, "stride": (stride, stride), "out_hw": (o, o),
          "padding": darknet_conv_padding(size, pad, 1, (h, h),
                                          (stride, stride), (o, o))}
    return ops, kw


def phase_int8_kernel():
    """The int8 GEMM against its plain version on seeded operands."""
    import torch

    from darknet_tpu_torch.ops import quant_matmul as qm

    checks = []
    for i, (name, m, k, n) in enumerate(INT8_EXACT + INT8_REAL):
        unit = i < len(INT8_EXACT)
        ops = int8_operands(m, k, n, seed=i, unit=unit)
        for leaky in (False,) if unit else (False, True):
            got = qm.int8_matmul(*ops, leaky=leaky)
            want = qm.int8_matmul_plain(*ops, leaky=leaky)
            torch.cuda.synchronize()
            res = {"name": name, "M": m, "K": k, "N": n, "unit": unit,
                   "leaky": leaky,
                   "max_abs_err": float((got - want).abs().max()),
                   "max_abs_out": float(want.abs().max()),
                   "equal": bool(torch.equal(got, want))}
            res["ms"] = cuda_ms(lambda: qm.int8_matmul(*ops, leaky=leaky))
            res["plain_ms"] = cuda_ms(
                lambda: qm.int8_matmul_plain(*ops, leaky=leaky))
            print("int8 check", json.dumps(res), flush=True)
            checks.append(res)
    require(all(c["max_abs_out"] < 2 ** 24 for c in checks if c["unit"]),
            "unit-scale checks stay below 2^24")
    for i, (name, b, h, c, n, size, stride) in enumerate(INT8_CONV):
        ops, kw = int8_conv_operands(b, h, c, n, size, stride, seed=10 + i)
        for dt in (torch.float32, torch.bfloat16):
            for leaky in (False, True):
                got = qm.int8_conv(*ops, out_dtype=dt, leaky=leaky, **kw)
                want = qm.int8_conv_plain(*ops, out_dtype=dt, leaky=leaky,
                                          **kw)
                torch.cuda.synchronize()
                res = {"name": name, "B": b, "H": h, "C": c, "N": n,
                       "size": size, "stride": stride,
                       "out": str(dt).split(".")[-1], "leaky": leaky,
                       "shape": list(got.shape),
                       "max_abs_err": float((got.float() - want.float())
                                            .abs().max()),
                       "equal": bool(torch.equal(got, want))}
                print("int8_conv check", json.dumps(res), flush=True)
                checks.append(res)
    bad = [c["name"] for c in checks if not c["equal"]]
    require(not bad, f"int8 GEMM and conv equal their plain versions: {bad}")
    return checks


def phase_int8_serve(card, bf16_img_s):
    """int8 serving of yolov4-608 at b=8, bf16, through the public API."""
    import os
    import tempfile

    import torch

    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch import Network
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    cfg = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)

    def int8_net():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Network.from_cfg(cfg, seed=0, compute_dtype=torch.bfloat16,
                                    device=DEVICE, int8=True)

    def served(net, f):
        tb, ov, probs = net.submit_detect_device(f)
        dets = net.device_out_to_dets(tb, ov, probs)
        require(tuple(tb.shape) == (SERVE_BATCH, 256, 4),
                f"int8 boxes shape {tuple(tb.shape)}")
        require(bool(torch.isfinite(tb).all() & torch.isfinite(ov).all()
                     & torch.isfinite(probs).all()), "int8 finite outputs")
        require(len(dets) == SERVE_BATCH, "one detection list per image")
        return sum(len(d) for d in dets)

    net = int8_net()
    n_q = sum("w_q" in p for p in net.params)
    require(n_q == INT8_CONVS, f"{INT8_CONVS} quantized convs, got {n_q}")
    rng = np.random.default_rng(1)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(3)]
    frames[1] = (frames[1] * 255).astype(np.uint8)

    # the dynamic path, counted: reset just before, read just after
    qm.launches = 0
    served(net, frames[0])
    dynamic = qm.launches
    print("int8 dynamic request: GEMM launches", dynamic, flush=True)
    require(dynamic == INT8_CONVS - 1,
            f"{INT8_CONVS - 1} GEMM launches per dynamic request, "
            f"got {dynamic}")

    calib = [rng.uniform(0, 1, shape[1:]).astype(np.float32)
             for _ in range(INT8_CALIB_FRAMES)]
    t0 = time.perf_counter()
    net.calibrate_int8(calib)
    calib_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "yolov4-608.scales")
        net.save_calibration(path)
        snet = int8_net()
        snet.load_calibration(path)
    scaled = [i for i, p in enumerate(net.params) if "x_scale" in p]
    require(len(scaled) == INT8_CONVS and all(
        torch.equal(net.params[i]["x_scale"], snet.params[i]["x_scale"])
        for i in scaled), "the loaded calibration has the same scales")
    del net

    # the calibrated path, counted
    qm.launches = 0
    kfr.launches = 0
    counts, region_counts, results = [], [], []
    for f in frames:
        results.append(served(snet, f))
        counts.append(qm.launches)
        region_counts.append(kfr.launches)
    launches = qm.launches
    print(f"int8 calibrated requests {len(frames)} (calibration "
          f"{calib_s:.2f} s on {INT8_CALIB_FRAMES} frames): GEMM launch "
          f"counts {counts}, region {region_counts}, detections {results}",
          flush=True)
    want = [INT8_CONVS * (i + 1) for i in range(len(frames))]
    require(counts == want, f"{INT8_CONVS} GEMM launches per calibrated "
            f"request, got {counts}")
    require(region_counts == [1, 2, 3], "one region launch per request")

    # every quantized conv of one calibrated request: the kernel's output
    # against the plain version on the same int8 operands, bitwise; the
    # explicit im2col must not run on the card on the way
    records, im2col_cuda = [], []
    orig_conv, orig_im2col = convmod.int8_conv, qm.im2col_int8

    def recorded(x_q, w_q, ws, bias, xs, **kw):
        out = orig_conv(x_q, w_q, ws, bias, xs, **kw)
        records.append({"ops": (x_q, w_q, ws, bias, xs), "kw": kw,
                        "out": out})
        return out

    def spy(x_q, *a, **k):
        if x_q.is_cuda:
            im2col_cuda.append(tuple(x_q.shape))
        return orig_im2col(x_q, *a, **k)

    convmod.int8_conv, qm.im2col_int8 = recorded, spy
    try:
        served(snet, frames[0])
    finally:
        convmod.int8_conv = orig_conv
    try:
        qm.launches = 0
        served(snet, frames[1])
        launches_req = qm.launches
    finally:
        qm.im2col_int8 = orig_im2col
    require(not im2col_cuda,
            f"no explicit im2col on the card, got {im2col_cuda[:3]}")
    require(launches_req == INT8_CONVS, f"{INT8_CONVS} int8_conv launches a "
            f"request, got {launches_req}")
    n_eq, err = 0, 0.0
    for r in records:
        ref = qm.int8_conv_plain(*r["ops"], **r["kw"])
        err = max(err, float((r["out"].float() - ref.float()).abs().max()))
        n_eq += bool(torch.equal(r["out"], ref))
        del r["out"]
    print(f"int8 per-conv check: {n_eq} of {len(records)} quantized convs "
          f"bitwise equal to the plain version (max abs err {err}); "
          f"explicit im2col calls on the card: {len(im2col_cuda)}; "
          f"int8_conv launches a request {launches_req}", flush=True)
    require(len(records) == INT8_CONVS and n_eq == INT8_CONVS,
            "every quantized conv bitwise equal to the plain version")

    # the work of one request's 91 convs, and its least time on the card
    macs = sum(r["ops"][0].shape[0] * r["kw"]["out_hw"][0]
               * r["kw"]["out_hw"][1] * r["ops"][1].numel() for r in records)
    nbytes = sum(r["ops"][0].numel() + r["ops"][1].numel()
                 + 8 * r["ops"][1].shape[0]
                 + r["ops"][0].shape[0] * r["kw"]["out_hw"][0]
                 * r["kw"]["out_hw"][1] * r["ops"][1].shape[0]
                 * torch.tensor([], dtype=r["kw"]["out_dtype"]).element_size()
                 for r in records)
    bound = max(2 * macs / PEAK_INT8, nbytes / PEAK_BYTES) * 1e3
    bound_by = "operations" if 2 * macs / PEAK_INT8 > nbytes / PEAK_BYTES \
        else "bytes"
    print(f"int8 convs of one request: {macs / 1e9:.3f} GMAC, "
          f"{nbytes / 1e9:.4f} GB read once and written once: bound "
          f"{bound:.4f} ms by {bound_by} (1,979 TOP/s int8, 3.35 TB/s)",
          flush=True)

    # times: the kernel's own durations in a profiler trace of one request;
    # CUDA-graph replays of the 91 launches (device time, no host); CUDA
    # events per conv (host launch included); the plain version; and
    # torch._int_mm (int32 out) on the same operands with A as the
    # explicit im2col (built here, outside the request)
    def kernels():
        for r in records:
            qm.int8_conv(*r["ops"], **r["kw"])

    lib_ops = [(qm.im2col_int8(r["ops"][0], r["kw"]["size"],
                               r["kw"]["size"], r["kw"]["stride"],
                               r["kw"]["padding"], r["kw"]["out_hw"]),
                r["ops"][1].t()) for r in records]

    def library():
        for a, b in lib_ops:
            torch._int_mm(a, b)

    def total(fn):
        return sum(cuda_ms(lambda r=r: fn(*r["ops"], **r["kw"]),
                           iters=5, warmup=1) for r in records)
    with torch.inference_mode():
        prof_req, n_req = profiled_ms(lambda: served(snet, frames[0]),
                                      "int8_gemm_kernel")
        prof_lib, n_lib = profiled_ms(library)
        g_k, g_l = graph_ms(kernels), graph_ms(library)
        g_l2, g_k2 = graph_ms(library), graph_ms(kernels)
        k_ms, p_ms = total(qm.int8_conv), total(qm.int8_conv_plain)
        p_ms2, k_ms2 = total(qm.int8_conv_plain), total(qm.int8_conv)
    del records, lib_ops
    print(f"int8_conv over one request's {INT8_CONVS} launches (b="
          f"{SERVE_BATCH}), device time: profiler {prof_req} ms "
          f"({n_req} kernels), CUDA graph {g_k:.3f} / {g_k2:.3f} ms; "
          f"torch._int_mm on the same operands: profiler {prof_lib} ms "
          f"({n_lib} kernels), CUDA graph {g_l:.3f} / {g_l2:.3f} ms; bound "
          f"{bound:.4f} ms [{card}]", flush=True)
    print(f"int8_conv over one request's {INT8_CONVS} launches, CUDA events "
          f"per conv (host launch included): kernel {k_ms:.3f} / "
          f"{k_ms2:.3f} ms, plain {p_ms:.3f} / {p_ms2:.3f} ms [{card}]",
          flush=True)
    top_kernels(snet, frames[0], "int8", card)

    img_s, spread, rates = serve_rate(snet, frames[0])
    print(f"serving yolov4-{SERVE_PX} int8 (calibrated, bf16) b="
          f"{SERVE_BATCH}: {img_s:.2f} img/s median of {RATE_WINDOWS} "
          f"windows of {RATE_REQUESTS} requests ({', '.join(f'{r:.2f}' for r in rates)}; "
          f"spread {100 * spread:.2f}%) beside bf16 {bf16_img_s:.2f} img/s "
          f"[{card}]", flush=True)
    return {"launches": launches, "region_launches": region_counts[-1],
            "img_s": img_s,
            "ms": prof_req if prof_req is not None else g_k,
            "plain_ms": p_ms, "max_abs_err": err,
            "library_ms": prof_lib if prof_lib is not None else g_l,
            "bound_ms": bound, "bound_by": bound_by}



def train_batch(graph, b, seed):
    """Seeded (x, truths) for the parity steps: uniform pixels, three
    boxes per image; for a net whose only head is a [cost] layer, normal
    flat targets of its input's size."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (b, graph.net.h, graph.net.w, 3)).astype(np.float32)
    if not graph.heads():
        return x, rng.normal(size=(b, graph.layers[-1].inputs)).astype(
            np.float32)
    head = graph.heads()[0]
    y = np.zeros((b, head.max_boxes, 5), np.float32)
    for i in range(b):
        for t in range(3):
            w, h = rng.uniform(0.1, 0.5, 2)
            y[i, t] = [rng.uniform(w / 2, 1 - w / 2),
                       rng.uniform(h / 2, 1 - h / 2), w, h,
                       rng.integers(0, head.classes)]
    return x, y


def train_state0(graph, p0):
    """The numpy training state before the first step: (params, zero
    momentum buffers, counter 0)."""
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.train.step import init_opt_state

    o = init_opt_state(graph, paramlib.train_params_to_torch(graph, p0, "cpu"))
    return p0, paramlib.train_params_to_numpy(graph, o["u"]), 0


def train_stepper(graph, device, dtype=None):
    """One training step on `device` from a numpy state (params, momentum
    buffers, iteration counter): returns (the state after it, its cost)."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.train.step import make_train_step

    step = make_train_step(graph, accum=TRAIN_ACCUM, compute_dtype=dtype,
                           train_act_dtype=dtype)

    def run(state, x, y):
        params, u, t = state
        p = paramlib.train_params_to_torch(graph, params, device)
        o = {"t": t, "u": paramlib.numpy_to_train_layout(graph, u, device)}
        p, o, c, _m = step(p, o, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device), graph.net.lr)
        return ((paramlib.train_params_to_numpy(graph, p),
                 paramlib.train_params_to_numpy(graph, o["u"]), o["t"]),
                float(c))
    return run


def update_gap(a, b, p0, keys):
    """(max |a - b| over the arrays named `keys`, the largest change from
    p0 among them)."""
    err = scale = 0.0
    for da, db, d0 in zip(a, b, p0):
        for k in keys:
            if k in d0:
                err = max(err, float(np.abs(da[k] - db[k]).max()))
                scale = max(scale, float(np.abs(da[k] - d0[k]).max()))
    return err, scale


def update_rel(a, b, p0, keys):
    """||a - b|| / ||b - p0|| over every array named `keys`, as one
    vector: the L2 distance of update a from update b, in b's size."""
    num = den = 0.0
    for da, db, d0 in zip(a, b, p0):
        for k in keys:
            if k in d0:
                db64 = db[k].astype(np.float64)
                num += float(np.square(da[k] - db64).sum())
                den += float(np.square(db64 - d0[k]).sum())
    return float(np.sqrt(num / den)) if den > 0 else float("inf")


def phase_train_parity(cases=None):
    """Phase 8 (a): each f32 step on the card from the state the CPU run
    reached before it (params, momentum, counter), held to the CPU's step
    from that state: updates, rolling statistics and momentum buffers.
    Run freely, yolov4's steps diverge on f32 rounding alone (see the CPU
    step test), so each step starts from the CPU's state.  `cases`:
    (name, cfg, batch seed, chaotic) each; a chaotic graph is held to
    YARDSTICK_V4 yardsticks capped at CAP, the others to TOL_TRAIN or
    YARDSTICK yardsticks."""
    import torch

    from darknet_tpu_torch import model_zoo
    from darknet_tpu_torch.nn import params as paramlib

    trainable, stats = ("w", "b", "scales"), ("mean", "var")
    if cases is None:
        cases = (("narrow CSP + SPP 64 px", TRAIN_CSP_CFG, 1, False),
                 ("yolov4-128", model_zoo.yolov4_cfg(128, 128), 2, True))
    for name, cfg, seed, chaotic in cases:
        g = quiet_graph(cfg.replace("burn_in=1000", "burn_in=0"), train=True)
        p0 = paramlib.init_params(g, seed=0)
        x, y = train_batch(g, TRAIN_PARITY_BATCH, seed)
        noise = np.random.default_rng(99).standard_normal(x.shape)
        x_eps = (x * (1 + 1e-7 * noise)).astype(np.float32)
        on_cpu, on_card = train_stepper(g, "cpu"), train_stepper(g, DEVICE)
        state = state0 = train_state0(g, p0)
        t_cpu = t_card = 0.0
        for n in range(TRAIN_PARITY_STEPS):
            t0 = time.perf_counter()
            cpu, c_cpu = on_cpu(state, x, y)
            t1 = time.perf_counter()
            card, c_card = on_card(state, x, y)
            card_eps, _ = on_card(state, x_eps, y)
            t_cpu, t_card = t_cpu + t1 - t0, t_card + time.perf_counter() - t1
            require(np.isfinite(c_card) and card[2] == cpu[2] == n + 1,
                    f"{name} step {n + 1}: a finite cost and the counter")
            if n == 0:
                first, c_first = card, c_card
            line = []
            for what, i, keys in (("updates", 0, trainable),
                                  ("stats", 0, stats),
                                  ("momentum", 1, trainable)):
                err, scale = update_gap(card[i], cpu[i], state[i], keys)
                yard, _ = update_gap(card[i], card_eps[i], state[i], keys)
                if chaotic:
                    ok = err <= min(YARDSTICK_V4 * yard + 1e-4 * scale,
                                    CAP * scale)
                else:
                    ok = err <= max((TOL_TRAIN if n else 1e-4) * scale,
                                    YARDSTICK * yard)
                line.append(f"{what} err {err:.3g} of {scale:.3g} (1e-7 "
                            f"input change: {yard:.3g})")
                require(scale > 0 and ok, f"{name} step {n + 1}: the card's "
                        f"{what} agree with the CPU's")
            print(f"train parity {name} step {n + 1} (from the CPU's state): "
                  f"cost card {c_card:.6g} cpu {c_cpu:.6g}; "
                  + "; ".join(line), flush=True)
            state = cpu
        print(f"train parity {name}: {TRAIN_PARITY_STEPS} steps, CPU "
              f"{t_cpu:.1f} s, card (two runs) {t_card:.1f} s", flush=True)
        if cfg is TRAIN_CSP_CFG:
            bf, c_bf = train_stepper(g, DEVICE, torch.bfloat16)(state0, x, y)
            ua = np.concatenate([(d[k] - d0[k]).ravel() for d, d0 in
                                 zip(first[0], p0) for k in sorted(d0)
                                 if k in trainable])
            ub = np.concatenate([(d[k] - d0[k]).ravel() for d, d0 in
                                 zip(bf[0], p0) for k in sorted(d0)
                                 if k in trainable])
            cos = float(ua @ ub / (np.linalg.norm(ua) * np.linalg.norm(ub)))
            rel = abs(c_bf - c_first) / abs(c_first)
            print(f"train bf16 step {name}: cost {c_bf:.6g} against f32 "
                  f"{c_first:.6g} (rel {rel:.3g}), updates' cosine "
                  f"{cos:.6f}", flush=True)
            require(np.isfinite(ub).all() and rel <= 0.01 and cos >= 0.99,
                    "the bf16 step is finite and close to the f32 step")


def phase_train_full(card):
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        return train_full(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_full(card, root):
    """Phase 8 (b) and (c), the data and the saves under `root`."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.data import loader as loaderlib
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.train import trainer as trainerlib

    t0 = time.perf_counter()
    files = synth.generate(os.path.join(root, "data"), n_train=TRAIN_IMAGES,
                           n_val=2, seed=0, size_range=TRAIN_IMAGE_PX)
    print(f"synth: {TRAIN_IMAGES} images in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    net_cfg = quiet_graph(cfg_text, train=True).net
    n_img = net_cfg.optimizer_batch
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    data = os.path.join(root, "obj.data")
    backup = os.path.join(root, "backup")
    with open(files["data"]) as f, open(data, "w") as g:
        g.write(f.read() + f"save = {backup}\n")

    # spies: each batch's content, the loader's assembly time per batch,
    # each step's time on the card's stream (CUDA events, no host sync),
    # one profiled step, and the end-to-end window: from the loader call
    # of the iteration after the profiled one (the card drained first) to
    # the final save, the trainer's own loader waits, copies and metric
    # drains inside it
    batches, assembly, steps, marks = [], [], [], {}
    next_batch = loaderlib.DetectionLoader.next
    make_batch = loaderlib.DetectionLoader._make_batch
    make_step = trainerlib.make_train_step
    save = trainerlib.DetectorTrainer.save

    def spy_next(self):
        if len(batches) == TRAIN_PROFILED_ITER:
            torch.cuda.synchronize()
            marks["start"] = time.perf_counter()
        x, y = next_batch(self)
        batches.append((x.shape[1:3], float(np.asarray(x != 0).mean()),
                        int((y[:, :, 0] > 0).sum())))
        return x, y

    def spy_make(self, seed, w, h):
        t = time.perf_counter()
        out = make_batch(self, seed, w, h)
        assembly.append(((h, w), time.perf_counter() - t))
        return out

    def spy_save(self, suffix=""):
        if suffix == "final":
            marks["end"] = time.perf_counter()
        return save(self, suffix)

    def spy_step(graph, **kw):
        step = make_step(graph, **kw)

        def timed(params, opt, x, y, lr, generator=None):
            hw = tuple(x.shape[1:3])
            if len(steps) + 1 == TRAIN_PROFILED_ITER:
                res = []
                trace_summary(lambda: res.append(step(params, opt, x, y, lr,
                                                      generator)),
                              f"train iteration {len(steps) + 1} ({hw})",
                              card, 10, cpu=False)
                steps.append((hw, None))
                return res[0]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = step(params, opt, x, y, lr, generator)
            ev[1].record()
            steps.append((hw, ev))
            return out
        return timed

    loaderlib.DetectionLoader.next = spy_next
    loaderlib.DetectionLoader._make_batch = spy_make
    trainerlib.DetectorTrainer.save = spy_save
    trainerlib.make_train_step = spy_step
    logs = []

    def log(line):
        logs.append(line)
        print(line, flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kfr.launches = qm.launches = 0
    t0 = time.perf_counter()
    try:
        avg = trainerlib.train_detector(
            data, cfg, max_iters=TRAIN_ITERS, device=DEVICE,
            loader_processes=TRAIN_LOADER_PROCS, log=log,
            metrics_path=os.path.join(root, "metrics.jsonl"))
    finally:
        loaderlib.DetectionLoader.next = next_batch
        loaderlib.DetectionLoader._make_batch = make_batch
        trainerlib.DetectorTrainer.save = save
        trainerlib.make_train_step = make_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (kfr.launches, qm.launches)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(root, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    losses = [r["loss"] for r in rows]
    print(f"train launches during training: region {launches[0]}, int8 "
          f"{launches[1]}", flush=True)
    require(launches == (0, 0), "training launches neither kernel")
    require(len(losses) == TRAIN_ITERS and all(np.isfinite(losses)),
            f"finite losses {losses}")
    require(len(batches) >= TRAIN_ITERS and all(
        nz > 0.5 and n > 0 for _s, nz, n in batches[:TRAIN_ITERS]),
        f"nonzero batches with truths {batches}")
    window = steps[TRAIN_PROFILED_ITER:]
    bucket = window[0][0] if window else None
    require(len(window) >= 2 and all(hw == bucket != (SERVE_PX, SERVE_PX)
                                     for hw, _ev in window),
            f"the window's iterations on the multi-scale bucket: {steps}")
    ms = [ev[0].elapsed_time(ev[1]) if ev else None for _hw, ev in steps]
    e2e = len(window) * n_img / (marks["end"] - marks["start"])
    step_ms = float(np.mean(ms[TRAIN_PROFILED_ITER:]))
    asm = [t for hw, t in assembly if hw == bucket]
    each = ", ".join(f"{hw[1]}:{t / 1e3:.3f}s" if t else f"{hw[1]}:profiled"
                     for (hw, _ev), t in zip(steps, ms))
    print(f"train yolov4-{SERVE_PX} batch={n_img} subdivisions="
          f"{net_cfg.subdiv} mosaic bf16 act16: bucket {bucket[1]}x"
          f"{bucket[0]}; steps by CUDA events {each}; "
          f"end to end over iterations {TRAIN_PROFILED_ITER + 1}-"
          f"{len(steps)}: {len(window) * n_img} images in "
          f"{marks['end'] - marks['start']:.3f} s, {e2e:.2f} img/s; the "
          f"step {step_ms / 1e3:.3f} s by CUDA events, "
          f"{n_img * 1e3 / step_ms:.2f} img/s; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
          f"{peak / 2**30:.2f} GiB; loader {n_img / np.mean(asm):.2f} "
          f"img/s ({np.mean(asm):.3f} s a batch, {TRAIN_LOADER_PROCS} "
          f"processes); wall {wall:.1f} s for {TRAIN_ITERS} iterations, "
          f"{t0 + wall - marks['end']:.1f} s of it after the window (the "
          f"final saves, the loader's close) [{card}]",
          flush=True)

    from darknet_tpu_torch.graph.builder import build_graph
    from darknet_tpu_torch.weights import io as wio

    final = os.path.join(backup, "yolov4_final.weights")
    trained, seen, _v = wio.load_weights(build_graph(cfg_text), final)
    require(seen == TRAIN_ITERS * n_img, f"seen {seen}")
    moved = sum(float(np.abs(p["mean"]).max()) > 0 for p in trained
                if "mean" in p)
    ck = np.load(os.path.join(backup, "yolov4_last.ckpt.npz"))
    mom = sum(float(np.abs(ck[k]).max()) > 0 for k in ck.files
              if k.startswith("opt/u/") and k.endswith("/w"))
    print(f"trained: rolling means moved in {moved} layers, momentum "
          f"nonzero in {mom} conv weights, avg loss {avg:.4f}", flush=True)
    require(moved > 100 and mom > 100, "moved rolling statistics and "
            "nonzero momentum buffers")

    # (c) train to serve: the trained weights through the region kernel
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg_text, weights=final,
                               compute_dtype=torch.bfloat16, device=DEVICE)
    frame = np.random.default_rng(5).uniform(
        0, 1, (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)).astype(np.float32)
    kfr.launches = 0
    tb, ov, probs = net.submit_detect_device(frame)
    dets = net.device_out_to_dets(tb, ov, probs)
    served = kfr.launches
    print(f"trained weights served: {sum(len(d) for d in dets)} detections "
          f"over {SERVE_BATCH} images, region kernel launches {served}",
          flush=True)
    require(served == 1, "one region kernel launch serving the trained net")
    require(bool(torch.isfinite(tb).all() & torch.isfinite(probs).all())
            and len(dets) == SERVE_BATCH, "finite served outputs")
    del net
    return {"img_s": e2e, "step_ms": step_ms, "peak": peak, "bucket": bucket}


def kept_matched(a, b):
    """(kept (image, slot, class) set of triple a, the same of triple b
    with each slot of a matched to b's slot of the nearest box, the
    largest box difference over a's candidates over the threshold)."""
    ta, tb = a[0].float().cpu().numpy(), b[0].float().cpu().numpy()
    slot = np.abs(ta[:, :, None, :] - tb[:, None, :, :]).max(-1).argmin(-1)
    pb = np.take_along_axis(b[2].float().cpu().numpy(), slot[..., None], 1)
    box = np.take_along_axis(tb, slot[..., None], 1)
    live = a[1].float().cpu().numpy() > 0
    err = float(np.abs(ta - box)[live].max()) if live.any() else 0.0
    return kept(a[2]), set(zip(*np.nonzero(pb > 0))), err


def phase_zoo(card):
    """Phase 9 (a): the rest of the yolo zoo at ZOO_PX, b=8: one bf16
    request each, and one f32 request with the kernel against the plain
    region on probe params (heads scaled to an objectness spread of about
    2, the threshold in a gap of the logits); equal kept sets."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    x = np.random.default_rng(9).uniform(
        0, 1, (SERVE_BATCH, ZOO_PX, ZOO_PX, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(DEVICE)
    for name, bn_scale in ZOO.items():
        fn = model_zoo.yolov3_spp_cfg if name == "yolov3-spp" else \
            model_zoo.MODELS[name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            net = Network.from_cfg(fn(ZOO_PX, ZOO_PX), seed=0,
                                   compute_dtype=torch.bfloat16,
                                   device=DEVICE)
        kfr.launches = 0
        tb, ov, probs = net.submit_detect_device(x)
        dets = net.device_out_to_dets(tb, ov, probs)
        bf16_launches = kfr.launches
        require(bool(torch.isfinite(tb).all() & torch.isfinite(probs).all())
                and tb.shape[0] == SERVE_BATCH and tb.shape[2] == 4
                and len(dets) == SERVE_BATCH, f"{name} bf16 request")
        g = net.graph
        del net

        def f32_net(params, mode, g=g):
            return Network(g, paramlib.params_to_torch(g, params, DEVICE),
                           device=DEVICE, fuse_regions=mode)

        n_heads = sum(l.kind == "yolo" for l in g.layers)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
                torch.inference_mode():
            p = probe_params(g, gains=(1.0,) * n_heads, bn_scale=bn_scale)
            net = f32_net(p, "plain")
            raw = net._fwd(net.params, xt)["raw_heads"]
            gains = [2.0 / float(h.reshape(-1, 3, h.shape[-1] // 3)[..., 4]
                                 .std()) for h in raw]
            net = f32_net(probe_params(g, gains=gains, bn_scale=bn_scale),
                          "plain")
            raw = net._fwd(net.params, xt)["raw_heads"]
            npar = probe_params(g, gains=gains, bn_scale=bn_scale,
                                obj_bias=obj_bias_for(raw, 0.25))
            del net, raw
            kfr.launches = 0
            a = f32_net(npar, "hybrid").submit_detect_device(x, thresh=0.25)
            f32_launches = kfr.launches
            b = f32_net(npar, "plain").submit_detect_device(x, thresh=0.25)
        ka, kb, err = kept_matched(a, b)
        print(f"zoo {name}-{ZOO_PX} b={SERVE_BATCH}: region launches bf16 "
              f"{bf16_launches}, f32 {f32_launches}; bf16 detections "
              f"{sum(len(d) for d in dets)}; f32 kernel kept {len(ka)} vs "
              f"plain {len(kb)} (slots matched), box max err {err:.3g} "
              f"[{card}]", flush=True)
        require(ka == kb and len(ka) > 0 and err <= 1e-4,
                f"{name}: the f32 kernel path keeps what the plain path "
                f"keeps")
        require(f32_launches == bf16_launches,
                f"{name}: one launch per planned region in both dtypes")


def unfolded(graph, params):
    """Folded numpy params as `.weights` params: identity BN (scales 1,
    mean 0, var 1 - 1e-5 in f32, whose fold divides by exactly 1), so a
    load that folds BN gives `params` back exactly."""
    one = np.float32(1) - np.float32(1e-5)
    out = []
    for l, p in zip(graph.layers, params):
        p = dict(p)
        if l.kind == "convolutional" and l.batch_normalize:
            n = p["b"].shape[0]
            p.update(scales=np.ones(n, np.float32),
                     mean=np.zeros(n, np.float32),
                     var=np.full(n, one, np.float32))
        out.append(p)
    return out


def phase_validate(card):
    root = tempfile.mkdtemp(prefix="chip_smoke_valid_")
    try:
        return validate(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def validate(card, root):
    """Phase 9 (b)-(d), the data and the weights under `root`."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.apps import cli
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.data.image import (load_image_rgb,
                                              resize_image_darknet)
    from darknet_tpu_torch.eval import map as maplib
    from darknet_tpu_torch.ops import nms as nmslib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.train.trainer import DetectorTrainer
    from darknet_tpu_torch.weights import io as wio

    files = synth.generate(os.path.join(root, "data"),
                           n_train=MAP_VALID_IMAGES, n_val=VALID_IMAGES,
                           seed=1)
    names = os.path.join(root, "all.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), VALID_CLASSES)]) + "\n")
    data = os.path.join(root, "obj.data")
    with open(data, "w") as f:
        f.write(f"classes = {VALID_CLASSES}\ntrain = {files['train_list']}\n"
                f"valid = {files['val_list']}\nnames = {names}\n"
                f"save = {os.path.join(root, 'backup')}\n")
    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    weights = os.path.join(root, "probe.weights")

    # probe weights whose threshold sits in a gap of the objectness logits
    # of the whole set (VALID_PASS candidates an image and head), so that
    # no decision of any image lies within f32 noise of it
    wio.save_weights(g, unfolded(g, probe_params(g)), weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=weights, device=DEVICE,
                               fuse_regions="plain")
    raw = []
    with torch.inference_mode():
        for s in range(0, VALID_IMAGES, VALID_BATCH):
            x = np.stack([resize_image_darknet(load_image_rgb(p), SERVE_PX,
                                               SERVE_PX)
                          for p in files["val_paths"][s:s + VALID_BATCH]])
            raw.append(net._fwd(net.params, torch.from_numpy(x).to(
                DEVICE))["raw_heads"])
    raw = [torch.cat(h) for h in zip(*raw)]
    bias = obj_bias_for(raw, VALID_THRESH, VALID_PASS * VALID_IMAGES)
    del net, raw
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)

    # spies: each validate_detector run with the kernels' counts set to 0
    # just before it and read just after, and the host NMS's time
    runs, nms_s = [], [0.0]
    validate_detector, nms_numpy = maplib.validate_detector, nmslib.nms_numpy

    def spy_validate(net, *a, **kw):
        kfr.launches = qm.launches = 0
        res = validate_detector(net, *a, **kw)
        runs.append({"net": net, "res": res, "region": kfr.launches,
                     "int8": qm.launches})
        return res

    def spy_nms(*a, **kw):
        t = time.perf_counter()
        out = nms_numpy(*a, **kw)
        nms_s[0] += time.perf_counter() - t
        return out

    def report(label, run, wall, nms):
        r = run["res"]
        print(f"valid {label}: mAP@0.5 {r.map:.6g}, {r.n_pred} predictions, "
              f"{r.n_gt} GT; prediction {r.imgs_per_s:.2f} img/s "
              f"({r.pred_time_s:.3f} s: forward, decode, host NMS; host "
              f"NMS {nms:.3f} s), whole call {VALID_IMAGES / wall:.2f} img/s "
              f"({wall:.3f} s, loading included); region launches "
              f"{run['region']}, int8 {run['int8']} [{card}]", flush=True)

    argv = ["-mode", "valid", "-data_file", data, "-model_file", cfg,
            "-weights_file", weights, "-device", DEVICE]
    calib = os.path.join(root, "yolov4-608.scales")
    batches = VALID_IMAGES // VALID_BATCH
    maplib.validate_detector, nmslib.nms_numpy = spy_validate, spy_nms
    try:
        # (b) the CLI, f32 (its default), then the same net with the plain
        # region, and a bf16 network beside it
        nms_s[0] = 0.0
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
        f32 = runs[-1]
        report(f"yolov4-{SERVE_PX} f32 (-mode valid)", f32, wall, nms_s[0])
        require(f32["region"] == batches and f32["int8"] == 0,
                f"one region launch a batch of {VALID_BATCH}: {f32['region']}")
        plain = Network(f32["net"].graph, f32["net"].params, device=DEVICE,
                        fuse_regions="plain")
        res_p = spy_validate(plain, files["val_paths"], VALID_CLASSES,
                             batch=VALID_BATCH, resize="darknet",
                             progress=False)
        del plain
        a, p = f32["res"], res_p
        print(f"valid kernel against plain: n_gt {a.n_gt} / {p.n_gt}, n_pred "
              f"{a.n_pred} / {p.n_pred}, mAP {a.map!r} / {p.map!r}, plain "
              f"launches {runs[-1]['region']}", flush=True)
        require(a.n_gt == p.n_gt and a.n_pred == p.n_pred > 0
                and a.map == p.map, "the kernel path's MapResult equals the "
                "plain path's")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bnet = Network.from_cfg(cfg, weights=weights, device=DEVICE,
                                    compute_dtype=torch.bfloat16)
        nms_s[0] = 0.0
        t0 = time.perf_counter()
        spy_validate(bnet, files["val_paths"], VALID_CLASSES,
                     batch=VALID_BATCH, resize="darknet", progress=False)
        report(f"yolov4-{SERVE_PX} bf16 Network", runs[-1],
               time.perf_counter() - t0, nms_s[0])
        require(runs[-1]["region"] == batches, "bf16: a launch a batch")
        del bnet
        runs[:] = runs[-1:]

        # (c) int8, calibrated on the first 4 images, the scales cached
        nms_s[0] = 0.0
        t0 = time.perf_counter()
        cli.main(argv + ["-int8", "-int8_calib", str(INT8_CALIB_FRAMES),
                         "-calib_file", calib])
        wall = time.perf_counter() - t0
        q = runs[-1]
        report(f"yolov4-{SERVE_PX} int8 (-mode valid -int8, f32 between "
               f"convs)", q, wall, nms_s[0])
        require(q["int8"] == INT8_CONVS * batches and q["region"] == batches
                and os.path.exists(calib), f"{INT8_CONVS} int8 launches a "
                f"batch: {q['int8']} over {batches} batches")
        require(np.isfinite(q["res"].map), "a finite int8 mAP")
        runs.clear()

        # (d) in-training mAP: DetectorTrainer.evaluate_map on the probe
        # weights, then once more after a training iteration (the
        # trainer's own first mAP would come at burn_in, iteration 1000),
        # which copies the trained weights to the cached inference net
        calls = []
        trainer = DetectorTrainer(
            cfg_text, files["train_paths"], weights=weights,
            classes=VALID_CLASSES, calc_map=True,
            val_paths=files["val_paths"][:MAP_VALID_IMAGES],
            save_dir=os.path.join(root, "train"), device=DEVICE,
            loader_processes=TRAIN_LOADER_PROCS, log=lambda *_: None)
        evaluate = trainer.evaluate_map

        def timed_evaluate(*a, **kw):
            nms_s[0] = 0.0
            t = time.perf_counter()
            m = evaluate(*a, **kw)
            calls.append((m, runs[-1], time.perf_counter() - t, nms_s[0]))
            return m
        trainer.evaluate_map = timed_evaluate
        try:
            trainer.evaluate_map()
            trainer.train(max_iters=1)
            trainer.evaluate_map()
        finally:
            trainer.close()
    finally:
        maplib.validate_detector, nmslib.nms_numpy = validate_detector, \
            nms_numpy
    print("in-training mAP (evaluate_map, f32, batch 4, "
          f"{MAP_VALID_IMAGES} images): " + "; ".join(
              f"call {i + 1}: mAP {m:.6g}, region launches {r['region']}, "
              f"{s:.3f} s ({r['res'].n_pred} predictions, prediction "
              f"{r['res'].pred_time_s:.3f} s, host NMS {n:.3f} s)"
              for i, (m, r, s, n) in enumerate(calls)) + f" [{card}]",
          flush=True)
    want = MAP_VALID_IMAGES // MAP_BATCH
    require(len(calls) == 2 and all(r["region"] == want and np.isfinite(m)
                                    for m, r, _s, _n in calls),
            "evaluate_map launches the region kernel a batch: "
            f"{[(m, r['region']) for m, r, _s, _n in calls]}")


def video_frames(n, seed, w=VIDEO_W, h=VIDEO_H):
    """n BGR frames of a synthetic clip: a fixed textured background (the
    synth set's grey noise over a coarse colour field) and three
    rectangles of the synth set's colours moving on straight lines."""
    from darknet_tpu_torch.data import synth

    rng = np.random.default_rng(seed)
    field = rng.integers(60, 200, (h // 80 + 1, w // 80 + 1, 3))
    bg = (np.repeat(np.repeat(field, 80, 0), 80, 1)[:h, :w] // 2
          + rng.integers(45, 65, (h, w, 3))).astype(np.uint8)
    movers = []
    for k in range(3):
        bw, bh = (int(v) for v in rng.integers(120, 260, 2))
        x0, y0 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
        vx, vy = (float(v) for v in rng.uniform(-6, 6, 2))
        movers.append((bw, bh, x0, y0, vx, vy, synth.COLORS[k % 4][::-1]))
    out = []
    for t in range(n):
        f = bg.copy()
        for bw, bh, x0, y0, vx, vy, col in movers:
            x = int(np.clip(x0 + vx * t, 0, w - bw))
            y = int(np.clip(y0 + vy * t, 0, h - bh))
            f[y:y + bh, x:x + bw] = col
        out.append(f)
    return out


VIDEO_GEO = """<polygons>
  <polygon><name>P1</name><num>4</num>
    <x0>0.05</x0><y0>0.1</y0><x1>0.45</x1><y1>0.1</y1>
    <x2>0.45</x2><y2>0.6</y2><x3>0.05</x3><y3>0.6</y3></polygon>
  <polygon><name>HANDOVER</name><num>4</num>
    <x0>0.55</x0><y0>0.3</y0><x1>0.98</x1><y1>0.3</y1>
    <x2>0.98</x2><y2>0.95</y2><x3>0.55</x3><y3>0.95</y3></polygon>
</polygons>
"""


class BlockCv2:
    """A meta-path finder that makes `import cv2` fail."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "cv2":
            raise ImportError(f"blocked: {name}")
        return None


def phase_video(card):
    root = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        return stream(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def stream(card, root):
    """Phase 10: the CLI's video, image and multi-video modes on
    yolov4-608, the clips and weights under `root`."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.apps import cli
    from darknet_tpu_torch.apps import visualize as viz
    from darknet_tpu_torch.apps.tracker import (ConfParam, Track,
                                                TrackManager,
                                                get_most_prob_dets)
    from darknet_tpu_torch.data import synth, video
    from darknet_tpu_torch.data.image import (make_letterbox_device,
                                              read_png, resize_image_cv,
                                              write_png)
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.weights import io as wio

    t_setup = time.perf_counter()
    names = os.path.join(root, "all.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), VALID_CLASSES)]) + "\n")
    data = os.path.join(root, "obj.data")
    with open(data, "w") as f:
        f.write(f"classes = {VALID_CLASSES}\nnames = {names}\n")
    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    clip = os.path.join(root, "clip.y4m")
    frames = video_frames(VIDEO_FRAMES, 1)
    video.write_y4m(clip, frames, VIDEO_FPS)
    cams = []
    for i in range(2):
        cams.append(os.path.join(root, f"cam{i}.y4m"))
        video.write_y4m(cams[-1], video_frames(VIDEO_SETS, 2 + i),
                        VIDEO_FPS)
        with open(os.path.join(root, f"cam{i}.xml"), "w") as f:
            f.write(VIDEO_GEO)
    png = os.path.join(root, "still.png")
    write_png(png, frames[0][..., ::-1])

    # probe weights whose threshold sits in a gap of the objectness logits
    # of the whole clip (VIDEO_PASS candidates a frame and head)
    g = quiet_graph(cfg_text)
    weights = os.path.join(root, "probe.weights")
    plain_net = Network(g, paramlib.params_to_torch(
        g, probe_params(g), DEVICE, torch.float32), device=DEVICE,
        fuse_regions="plain")
    raw = []
    with torch.inference_mode():
        for s in range(0, VIDEO_FRAMES, VALID_BATCH):
            x = np.stack([resize_image_cv(f[..., ::-1].copy(), SERVE_PX,
                                          SERVE_PX)
                          for f in frames[s:s + VALID_BATCH]])
            raw.append(plain_net._fwd(plain_net.params, plain_net._u8_unit[
                torch.from_numpy(x).to(DEVICE).int()])["raw_heads"])
    raw = [torch.cat(h) for h in zip(*raw)]
    bias = obj_bias_for(raw, VIDEO_THRESH, VIDEO_PASS * VIDEO_FRAMES)
    del plain_net, raw
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)
    print(f"video setup: {VIDEO_FRAMES} frames {VIDEO_W}x{VIDEO_H} 4:2:0 "
          f"and 2 cameras x {VIDEO_SETS}, probe weights, "
          f"{time.perf_counter() - t_setup:.1f} s", flush=True)

    base = ["-data_file", data, "-model_file", cfg, "-weights_file", weights,
            "-thresh", str(VIDEO_THRESH), "-out_dir",
            os.path.join(root, "out"), "-device", DEVICE]

    def drive(argv, load=None, cams=1):
        """cli.main(argv) with the kernels' counts set to 0 just before and
        read just after, every frame's most-prob detections and tracks,
        the proc times, and the rate of frames (frame sets of `cams`
        frames) between the first and the last one's finalize; `load`
        replaces the CLI's network loader."""
        log, procs, stamps = [], [], []
        tail, load_net = cli._host_tail, cli._load_network
        proc_time = viz.draw_proc_time

        def spy_tail(net, md, frame, dets, args, track_manager=None):
            out = tail(net, md, frame, dets, args, track_manager)
            stamps.append(time.perf_counter())
            log.append(([(d.bbox, d.cid, d.prob) for d in out[1]],
                        [] if track_manager is None else [
                            (t.bbox, t.label, t.status)
                            for t in track_manager.get_tracks()]))
            return out

        def spy_proc(img, ms):
            procs.append(ms)
            return proc_time(img, ms)

        cli._host_tail, viz.draw_proc_time = spy_tail, spy_proc
        if load is not None:
            cli._load_network = load
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                Track._shared_label = 0       # labels count from 0 a run
                kfr.launches = qm.launches = 0
                for k in kfr.variant_launches:
                    kfr.variant_launches[k] = 0
                t0 = time.perf_counter()
                cli.main(base + argv)
                wall = time.perf_counter() - t0
                counts = {"region": kfr.launches, "int8": qm.launches,
                          **kfr.variant_launches}
        finally:
            cli._host_tail, viz.draw_proc_time = tail, proc_time
            cli._load_network = load_net
        sets = stamps[cams - 1::cams]     # a frame set's last finalize
        fps = (len(sets) - 1) / (sets[-1] - sets[0]) if len(sets) > 1 \
            else float("nan")
        return {"log": log, "counts": counts, "procs": procs, "wall": wall,
                "fps": fps, "frames": len(sets)}

    def report(label, r, per):
        p = np.asarray(r["procs"])
        print(f"video {label}: {r['frames']} {per}, {r['fps']:.2f} {per}/s "
              f"end to end (first to last frame's finalize: decode, "
              f"upload, serve, track, draw, the reader thread), proc time "
              f"median {np.median(p):.2f} ms (p10 {np.percentile(p, 10):.2f},"
              f" p90 {np.percentile(p, 90):.2f}), the call "
              f"{r['wall']:.2f} s with the network's load; launches "
              f"{r['counts']} [{card}]", flush=True)

    def same_frames(a, b, label):
        """Frame by frame: the detections matched by box (rtol 1e-4), the
        same classes, and the same track labels and statuses."""
        require(len(a["log"]) == len(b["log"]) == VIDEO_FRAMES,
                f"{label}: {len(a['log'])} and {len(b['log'])} frames")
        n_det = n_trk = 0
        for i, ((da, ta), (db, tb)) in enumerate(zip(a["log"], b["log"])):
            require(len(da) == len(db), f"{label} frame {i}: {len(da)} and "
                    f"{len(db)} detections")
            for bbox, cid, prob in da:
                hit = [d for d in db if np.allclose(bbox, d[0], rtol=1e-4,
                                                    atol=1e-6)]
                require(len(hit) == 1 and hit[0][1] == cid
                        and abs(hit[0][2] - prob) <= 1e-4,
                        f"{label} frame {i}: detection {bbox} unmatched")
            require([t[1:] for t in ta] == [t[1:] for t in tb],
                    f"{label} frame {i}: track labels and statuses differ")
            for x, y in zip(ta, tb):
                require(np.allclose(x[0], y[0], rtol=1e-4, atol=1e-6),
                        f"{label} frame {i}: track boxes differ")
            n_det += len(da)
            n_trk += len(ta)
        require(n_det > 0 and n_trk > 0, f"{label}: detections and tracks "
                f"({n_det}, {n_trk})")
        return n_det, n_trk

    clip_argv = ["-mode", "video", "-input_file", clip]

    def load_plain(args, train=False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Network.from_cfg(args.model_file,
                                    weights=args.weights_file,
                                    device=DEVICE, fuse_regions="plain")
    # (a) f32 (the CLI's default), tracking, the device path (auto): first
    # the plain path (the region prefix as torch convs), which warms the
    # process up, then the kernel path at depths 2 and 1
    plain = drive(clip_argv + ["-pipeline_depth", "2"], load=load_plain)
    report("(a) plain path (fuse_regions=\"plain\"), -pipeline_depth 2",
           plain, "frames")
    require(plain["counts"]["region"] == 0, "the plain path launches no "
            "region kernel")
    results = {}
    for depth in (2, 1):
        r = results[depth] = drive(clip_argv + ["-pipeline_depth",
                                                str(depth)])
        report(f"(a) yolov4-608 f32, -pipeline_depth {depth}", r, "frames")
        require(r["counts"]["region"] == VIDEO_FRAMES
                and r["counts"]["region_kernel"] == VIDEO_FRAMES
                and r["counts"]["int8"] == 0,
                f"one FFMA region launch a frame: {r['counts']}")
        n_det, n_trk = same_frames(r, plain, f"(a) depth {depth} against "
                                   f"plain")
        print(f"video (a) depth {depth}, kernel path against plain path: "
              f"{VIDEO_FRAMES} frames, {n_det} detections and {n_trk} "
              f"visible tracks, equal frame by frame (boxes rtol 1e-4; "
              f"labels, statuses) [{card}]", flush=True)
    d2, d1 = results[2], results[1]

    # (b) int8 with calibrated scales
    calib = os.path.join(root, "yolov4-608.scales")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qnet = Network.from_cfg(cfg, weights=weights, int8=True,
                                device=DEVICE)
    qnet.calibrate_int8([resize_image_cv(f[..., ::-1].astype(np.float32)
                                         / 255.0, SERVE_PX, SERVE_PX)
                         for f in frames[:INT8_CALIB_FRAMES]])
    qnet.save_calibration(calib)
    del qnet
    q = drive(clip_argv + ["-int8", "-calib_file", calib])
    report("(b) yolov4-608 -int8 (calibrated, f32 between convs)", q,
           "frames")
    require(q["counts"]["int8"] == INT8_CONVS * VIDEO_FRAMES
            and q["counts"]["region"] == VIDEO_FRAMES,
            f"{INT8_CONVS} int8 launches a frame: {q['counts']}")
    require(all(np.isfinite(b).all() for dets, _t in q["log"]
                for b, _c, _p in dets) and sum(len(d) for d, _t in q["log"]),
            "finite int8 detections")

    # (c) two cameras, letterboxed on the card, zones, handover
    boxes = []
    letterbox = cli._device_letterbox

    def spy_letterbox(net, frames_u8):
        out = letterbox(net, frames_u8)
        if len(boxes) < 3:
            boxes.append((np.array(frames_u8), out.cpu().numpy()))
        return out
    cli._device_letterbox = spy_letterbox
    try:
        mv = drive(["-mode", "multi-video", "-input_file", ",".join(cams),
                    "-letter_box"], cams=2)
    finally:
        cli._device_letterbox = letterbox
    report("(c) multi-video, 2 cameras, -letter_box, zones", mv,
           "frame sets")
    require(mv["counts"]["region"] == VIDEO_SETS and mv["frames"] ==
            VIDEO_SETS, f"one region launch a frame set: {mv['counts']}")
    lbx_err = 0.0
    for fr, got in boxes:
        want = make_letterbox_device(VIDEO_H, VIDEO_W, SERVE_PX, SERVE_PX,
                                     device="cpu")(fr).numpy()
        lbx_err = max(lbx_err, float(np.abs(got - want).max()))
    print(f"video (c) the card's letterbox against the CPU's on "
          f"{len(boxes)} frame sets: max abs error {lbx_err:.3g}", flush=True)
    require(len(boxes) == 3 and lbx_err <= LETTERBOX_TOL,
            "the card's letterbox equals the CPU's")

    # (d) one 1280x720 PNG
    img = drive(["-mode", "image", "-input_file", png])
    out_png = os.path.join(root, "out", "det_still.png")
    require(os.path.exists(out_png) and read_png(out_png).shape ==
            (VIDEO_H, VIDEO_W, 3) and img["counts"]["region"] == 1,
            "-mode image writes det_still.png at 1280x720")
    print(f"video (d) -mode image: {len(img['log'][0][0])} objects, "
          f"det_still.png {VIDEO_W}x{VIDEO_H}", flush=True)

    # (e) -save_output without cv2 raises before any work
    opened = []
    open_video, load_net = video.open_video, cli._load_network
    blocker, saved = BlockCv2(), sys.modules.pop("cv2", None)
    sys.meta_path.insert(0, blocker)
    video.open_video = lambda p: opened.append(p) or open_video(p)
    cli._load_network = lambda *a, **k: opened.append("net") or \
        load_net(*a, **k)
    try:
        cli.main(base + clip_argv + ["-save_output"])
        raised = None
    except video.VideoFormatError as e:
        raised = str(e)
    finally:
        sys.meta_path.remove(blocker)
        video.open_video, cli._load_network = open_video, load_net
        if saved is not None:
            sys.modules["cv2"] = saved
    require(raised is not None and not opened,
            f"-save_output without cv2 raises before any work: {raised}, "
            f"{opened}")
    print(f"video (e) -save_output without cv2: raised before any work "
          f"({raised})", flush=True)

    # where a frame's time goes: the same stages one after the other,
    # synchronised, on the kernel path's f32 network; one profiled frame
    args = cli.build_parser().parse_args(base + clip_argv)
    md = cli._load_metadata(args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=weights, device=DEVICE)
    tm = TrackManager(ConfParam.from_fps(VIDEO_FPS), VIDEO_FPS, 0.3)
    reader = video.open_video(clip)
    split = {k: [] for k in ("decode", "resize", "serve", "copy_back",
                             "track", "draw")}
    for i in range(VIDEO_SPLIT_FRAMES):
        t = [time.perf_counter()]
        _ok, frame = reader.read()
        t.append(time.perf_counter())
        x = resize_image_cv(cli._bgr_to_rgb(frame), SERVE_PX, SERVE_PX)
        t.append(time.perf_counter())
        out = net.submit_detect_device(x, thresh=args.thresh,
                                       nms=args.nms_thresh, top_k=args.top_k)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        dets = net.device_out_to_dets(*out)[0]
        t.append(time.perf_counter())
        tm.track(get_most_prob_dets(dets))
        t.append(time.perf_counter())
        rgb = cli._bgr_to_rgb(frame)
        viz.draw_trackings(rgb, tm.get_tracks(), md.names)
        viz.draw_proc_time(rgb, 10.0)
        viz.draw_frame_info(rgb, i, VIDEO_FRAMES)
        cli._bgr_to_rgb(rgb)
        t.append(time.perf_counter())
        for k, a, b in zip(split, t, t[1:]):
            split[k].append((b - a) * 1e3)
    reader.release()
    med = {k: float(np.median(v[1:])) for k, v in split.items()}
    print("video frame split, synchronised, median ms over "
          f"{VIDEO_SPLIT_FRAMES - 1} frames (f32, the kernel path): "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; sum {sum(med.values()):.3f} [{card}]", flush=True)
    _ok, frame = video.open_video(clip).read()
    tm = TrackManager(ConfParam.from_fps(VIDEO_FPS), VIDEO_FPS, 0.3)
    busy = trace_summary(lambda: cli._proc_frame(net, md, frame, args, tm),
                         "video frame (_proc_frame, f32)", card)
    require(busy is not None, "the profiled frame ran on the card")
    return {"fps_d2": d2["fps"], "fps_d1": d1["fps"], "fps_int8": q["fps"],
            "fps_multi": mv["fps"]}


def gaussian_cfg(px):
    """Gaussian YOLOv3 at px, GAUSS_CLASSES classes, the zoo's batch=64
    and subdivisions=8."""
    from darknet_tpu_torch import model_zoo

    return model_zoo.gaussian_yolov3_cfg(px, px, classes=GAUSS_CLASSES)


def phase_gaussian(card):
    """Phase 11: Gaussian YOLOv3 (`model_zoo.gaussian_yolov3_cfg`,
    darknet53 + FPN at full width and depth) at GAUSS_PX with
    GAUSS_CLASSES classes: serving, int8, Network.resize, training and
    validation, the data and weights under a temporary directory."""
    root = tempfile.mkdtemp(prefix="chip_smoke_gaussian_")
    try:
        t0 = time.perf_counter()
        npar, bf16_img_s = gaussian_serve(card)
        gaussian_int8(card, bf16_img_s)
        gaussian_resize(card, root, npar)
        gaussian_train(card, root)
        gaussian_valid(card, root)
        print(f"phase 11 (Gaussian YOLOv3) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gaussian_probe(g, x, thresh=0.25, n_pass=PROBE_PASS):
    """Folded probe params for the Gaussian graph `g` whose threshold
    `thresh` sits in a gap of the objectness logits (entry 8) over the
    frames `x` (n_pass candidates a head over them all): heads scaled to
    a spread of about 2 (BN scales 1.2, as yolov3's in phase 9), sigmas
    at SIGMA_PROBE_BIAS."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib

    def raw_heads(p):
        net = Network(g, paramlib.params_to_torch(g, p, DEVICE),
                      device=DEVICE, fuse_regions="plain")
        raw = [net._fwd(net.params, torch.from_numpy(
            x[s:s + SERVE_BATCH]).to(DEVICE))["raw_heads"]
            for s in range(0, len(x), SERVE_BATCH)]
        return [torch.cat(h) for h in zip(*raw)]

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        raw = raw_heads(probe_params(g, gains=(1.0,) * 3, bn_scale=1.2))
        gains = [2.0 / float(h.reshape(-1, 3, h.shape[-1] // 3)[..., 8]
                             .std()) for h in raw]
        raw = raw_heads(probe_params(g, gains=gains, bn_scale=1.2))
        bias = obj_bias_for(raw, thresh, n_pass, obj=8)
    return probe_params(g, gains=gains, bn_scale=1.2, obj_bias=bias)


def gaussian_serve(card):
    """Phase 11 (a): bf16 requests at b=8 (one tensor-core region launch
    each, by the per-kernel counts), then one f32 request through the FFMA
    kernel against the plain region on probe params (equal kept sets once
    slots are matched by box), the host path's Detection.uc on both, and
    the bf16 rate.  Returns the probe params and the bf16 img/s."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(gaussian_cfg(GAUSS_PX), seed=0,
                               compute_dtype=torch.bfloat16, device=DEVICE)
    g = net.graph
    require([l.kind for l in g.heads()] == ["gaussian_yolo"] * 3 and
            sum(l.kind == "convolutional" for l in g.layers) == 75 and
            len(g.layers) == 107, "Gaussian YOLOv3: 107 layers, 75 convs, "
            "three [Gaussian_yolo] heads")
    rng = np.random.default_rng(11)
    frames = [rng.uniform(0, 1, (SERVE_BATCH, GAUSS_PX, GAUSS_PX, 3))
              .astype(np.float32) for _ in range(3)]
    pre = dict(kfr.variant_launches)
    kfr.launches = 0
    counts, dets_n = [], []
    for f in frames:
        tb, ov, probs = net.submit_detect_device(f)
        dets = net.device_out_to_dets(tb, ov, probs)
        counts.append(kfr.launches)
        require(tuple(tb.shape) == (SERVE_BATCH, 256, 4) and
                tuple(probs.shape) == (SERVE_BATCH, 256, GAUSS_CLASSES) and
                bool(torch.isfinite(tb).all() & torch.isfinite(probs).all())
                and len(dets) == SERVE_BATCH, "a finite Gaussian triple")
        dets_n.append(sum(len(d) for d in dets))
    tc = kfr.variant_launches["region_tc_kernel"] - pre["region_tc_kernel"]
    plan = net._fwd.region_plans[0]
    sub, _k = fr.hybrid_prefix(plan)
    print(f"gaussian bf16 requests: region launch counts {counts} "
          f"(region_tc_kernel {tc}), detections {dets_n}; the region "
          f"layers {plan.start}-{plan.stop}, its prefix {len(sub.steps)} "
          f"steps, (B,{sub.h},{2 * sub.w2},{sub.out_c}) in s2d "
          f"coordinates, tile {kfr.kernel_plan(sub, 2).tile}", flush=True)
    require(counts == [1, 2, 3] and tc == 3,
            f"one tensor-core region launch a Gaussian request: {counts}")
    # the region kernel at this slice's serving shape: CUDA events, the
    # profiler's count and time, the plain version, the bound
    ws, bs = fr.step_weights(sub.steps, net.params, torch.bfloat16)
    xt = torch.from_numpy(frames[0]).to(DEVICE)
    with torch.inference_mode():
        def kernel():
            return kfr.region_call(sub, xt, ws, bs,
                                   compute_dtype=torch.bfloat16)

        def plain():
            return fr.region_plain(sub, xt, ws, bs,
                                   compute_dtype=torch.bfloat16)
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
        p_ms2, k_ms2 = cuda_ms(plain), cuda_ms(kernel)
        prof_ms, n_prof = profiled_ms(kernel, "region_tc_kernel")
        out = kernel()
        err, scale, share, ok = held_to_plain(out, plain(), TOL_BF16)
    bound, bound_by = region_bound(sub, xt, ws, bs, out.shape)
    print(f"gaussian region prefix b={SERVE_BATCH} bf16: tensor-core kernel "
          f"{k_ms:.3f} / {k_ms2:.3f} ms by CUDA events, {prof_ms} ms by "
          f"torch.profiler ({n_prof} events); plain {p_ms:.3f} / "
          f"{p_ms2:.3f} ms; bound {bound:.4f} ms by {bound_by}; max abs err "
          f"{err:.4g} at scale {scale:.4g}, {100 * share:.3f}% of the "
          f"elements differ [{card}]", flush=True)
    require(ok, "the region kernel at the Gaussian serving shape agrees "
            "with its plain version")
    del xt, out
    top_kernels(net, frames[0], "gaussian bf16", card)
    img_s, spread, rates = serve_rate(net, frames[0])
    print(f"serving gaussian-yolov3-{GAUSS_PX} bf16 b={SERVE_BATCH}: "
          f"{img_s:.2f} img/s median of {RATE_WINDOWS} windows of "
          f"{RATE_REQUESTS} requests "
          f"({', '.join(f'{r:.2f}' for r in rates)}; spread "
          f"{100 * spread:.2f}%) [{card}]", flush=True)
    del net

    # one f32 request: the FFMA kernel against the plain region
    x = frames[0]
    npar = gaussian_probe(g, x)
    nets, out, host = {}, {}, {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        for mode in ("hybrid", "plain"):
            nets[mode] = Network(g, paramlib.params_to_torch(g, npar, DEVICE),
                                 device=DEVICE, fuse_regions=mode)
            pre = kfr.variant_launches["region_kernel"]
            out[mode] = nets[mode].submit_detect_device(x, thresh=0.25)
            out[mode + "_launches"] = kfr.variant_launches[
                "region_kernel"] - pre
            host[mode] = nets[mode].detect_batch(x, thresh=0.25)
    ka, kb, err = kept_matched(out["hybrid"], out["plain"])
    ha, hb = host["hybrid"], host["plain"]
    uc_err = max((float(np.max(np.abs(a.uc - b.uc) / np.abs(b.uc)))
                  for da, db in zip(ha, hb) for a, b in zip(da, db)),
                 default=0.0)
    same_host = [len(d) for d in ha] == [len(d) for d in hb] and all(
        np.array_equal(a.prob > 0, b.prob > 0) and
        np.allclose(a.bbox, b.bbox, rtol=1e-4, atol=1e-5)
        for da, db in zip(ha, hb) for a, b in zip(da, db))
    n_host = sum(len(d) for d in ha)
    print(f"gaussian f32 request: FFMA kernel launches "
          f"{out['hybrid_launches']}, plain {out['plain_launches']}; kept "
          f"{len(ka)} vs {len(kb)} (slots matched), box max err {err:.3g}; "
          f"host path {n_host} detections, uc rel err {uc_err:.3g}",
          flush=True)
    require(out["hybrid_launches"] == 1 and out["plain_launches"] == 0,
            "the f32 Gaussian request launches the FFMA kernel once")
    require(ka == kb and len(ka) > 0 and err <= 1e-4,
            "f32 Gaussian kernel path keeps what the plain path keeps")
    require(n_host > 0 and same_host and uc_err <= 1e-4 and all(
        d.uc.shape == (4,) for dd in ha for d in dd),
        "the host path's detections and Detection.uc equal the plain path's")
    return npar, img_s


def gaussian_int8(card, bf16_img_s):
    """Phase 11 (b): int8 Gaussian YOLOv3 (bf16 between the convs): a
    dynamic request, calibrate_int8 on INT8_CALIB_FRAMES frames, then a
    calibrated request with every quantized conv's output held to the
    plain version on the same operands, bitwise; the int8 rate."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(gaussian_cfg(GAUSS_PX), seed=0,
                               compute_dtype=torch.bfloat16, device=DEVICE,
                               int8=True)
    n_q = sum("w_q" in p for p in net.params)
    heads_q = [l.index - 1 for l in net.graph.heads()
               if "w_q" in net.params[l.index - 1]]
    require(n_q == GAUSS_INT8_CONVS and not heads_q,
            f"{GAUSS_INT8_CONVS} quantized convs, none feeding a head: "
            f"{n_q}, {heads_q}")
    rng = np.random.default_rng(12)
    shape = (SERVE_BATCH, GAUSS_PX, GAUSS_PX, 3)
    frame = rng.uniform(0, 1, shape).astype(np.float32)

    def served():
        tb, ov, probs = net.submit_detect_device(frame)
        require(bool(torch.isfinite(tb).all() & torch.isfinite(probs).all()),
                "finite int8 Gaussian outputs")
        return sum(len(d) for d in net.device_out_to_dets(tb, ov, probs))

    qm.launches = 0
    served()
    dynamic = qm.launches
    net.calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(np.float32)
                        for _ in range(INT8_CALIB_FRAMES)])
    records = []
    orig = convmod.int8_conv

    def recorded(x_q, w_q, ws, bias, xs, **kw):
        y = orig(x_q, w_q, ws, bias, xs, **kw)
        records.append(((x_q, w_q, ws, bias, xs), kw, y))
        return y

    qm.launches = kfr.launches = 0
    convmod.int8_conv = recorded
    try:
        n_det = served()
    finally:
        convmod.int8_conv = orig
    calibrated, region = qm.launches, kfr.launches
    n_rec = len(records)
    n_eq = sum(bool(torch.equal(y, qm.int8_conv_plain(*ops, **kw)))
               for ops, kw, y in records)
    print(f"gaussian int8: {n_q} quantized convs; int8 launches a request: "
          f"dynamic {dynamic}, calibrated {calibrated} (region {region}); "
          f"{n_eq} of {n_rec} quantized convs bitwise equal to the "
          f"plain version; {n_det} detections", flush=True)
    del records
    require(calibrated == n_rec == n_eq == n_q and region == 1,
            f"{n_q} int8 launches, each bitwise equal to its plain version, "
            f"and one region launch a calibrated request")
    require(dynamic == n_q - 1, f"{n_q - 1} int8 launches a dynamic request "
            f"(layer 12 in floating point inside the region): {dynamic}")
    top_kernels(net, frame, "gaussian int8", card)
    img_s, spread, rates = serve_rate(net, frame)
    print(f"serving gaussian-yolov3-{GAUSS_PX} int8 (calibrated, bf16) b="
          f"{SERVE_BATCH}: {img_s:.2f} img/s median of {RATE_WINDOWS} "
          f"windows of {RATE_REQUESTS} requests "
          f"({', '.join(f'{r:.2f}' for r in rates)}; spread "
          f"{100 * spread:.2f}%) beside bf16 {bf16_img_s:.2f} img/s "
          f"[{card}]", flush=True)


def gaussian_resize(card, root, npar):
    """Phase 11 (c): a bf16 network built at 416 from a .weights file,
    resized to GAUSS_PX and then to 608: each serves a triple bitwise
    equal to a network built at that size from the same file, with one
    region launch a request on the new size's plan (the launched table's
    output extent and tile recorded)."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.weights import io as wio

    g = quiet_graph(gaussian_cfg(GAUSS_PX))
    weights = os.path.join(root, "gaussian-probe.weights")
    wio.save_weights(g, unfolded(g, npar), weights)

    def build(px):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Network.from_cfg(gaussian_cfg(px), weights=weights,
                                    compute_dtype=torch.bfloat16,
                                    device=DEVICE)

    launched = []
    launch = kfr.launch

    def spy(kp, *a, **k):
        launched.append((kp.tile, int(kp.table[3]), int(kp.table[4])))
        return launch(kp, *a, **k)

    net = build(GAUSS_RESIZE[0])
    rng = np.random.default_rng(13)
    kfr.launch = spy
    try:
        for px in GAUSS_RESIZE[1:]:
            x = rng.uniform(0, 1, (SERVE_BATCH, px, px, 3)).astype(
                np.float32)
            resized = net.resize(px, px)
            launched.clear()
            kfr.launches = 0
            a = resized.submit_detect_device(x, thresh=0.25)
            n_resized, seen = kfr.launches, list(launched)
            b = build(px).submit_detect_device(x, thresh=0.25)
            torch.cuda.synchronize()
            sub, _k = fr.hybrid_prefix(resized._fwd.region_plans[0])
            same = all(torch.equal(u, v) for u, v in zip(a, b))
            print(f"gaussian resize {GAUSS_RESIZE[0]} -> {px}: triple "
                  f"bitwise equal to a network built at {px}: {same}; "
                  f"region launches {n_resized} (tile, out h, out w) "
                  f"{seen}; kept {len(kept(a[2]))} [{card}]", flush=True)
            require(same and resized.params is net.params,
                    f"the resized network serves what a network built at "
                    f"{px} serves")
            require(n_resized == 1 and [t[1:] for t in seen] == [
                (sub.h, 2 * sub.w2)],
                    f"one region launch on the {px} plan: {seen}")
            del resized
    finally:
        kfr.launch = launch


def gaussian_train(card, root):
    """Phase 11 (d): parity of the narrow Gaussian graph on the card
    against the port's CPU run (phase 8 (a)'s form, chaotic), then
    train_detector on Gaussian YOLOv3 at GAUSS_PX, batch=64,
    subdivisions=8, GAUSS_CLASSES classes, on synth images for
    GAUSS_TRAIN_ITERS iterations: finite losses and uc_loss, moved
    rolling statistics, nonzero momentum buffers, no kernel launch."""
    import torch

    from darknet_tpu_torch.data import loader as loaderlib
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.train import step as steplib
    from darknet_tpu_torch.train import trainer as trainerlib
    from darknet_tpu_torch.weights import io as wio

    phase_train_parity((("narrow Gaussian 64 px", GAUSSIAN_TRAIN_CFG, 32,
                         True),))

    t0 = time.perf_counter()
    files = synth.generate(os.path.join(root, "train"),
                           n_train=GAUSS_TRAIN_IMAGES, n_val=2, seed=2,
                           size_range=TRAIN_IMAGE_PX)
    synth_s = time.perf_counter() - t0
    cfg_text = gaussian_cfg(GAUSS_PX)
    cfg = os.path.join(root, "gaussian.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    names = os.path.join(root, "gaussian.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), GAUSS_CLASSES)]) + "\n")
    backup = os.path.join(root, "backup")
    data = os.path.join(root, "gaussian.data")
    with open(data, "w") as f:
        f.write(f"classes = {GAUSS_CLASSES}\ntrain = {files['train_list']}"
                f"\nnames = {names}\nsave = {backup}\n")

    # spies: each head delta's uc_loss, and the end-to-end window from
    # the second iteration's batch (the card drained first) to the final
    # save, the trainer's loader waits, copies and metric drains inside
    uc, marks, n_next = [], {}, [0]
    delta = steplib.HEAD_DELTA["gaussian_yolo"]
    next_batch = loaderlib.DetectionLoader.next
    save = trainerlib.DetectorTrainer.save

    def spy_delta(*a, **k):
        d, c, m = delta(*a, **k)
        uc.append(m["uc_loss"])
        return d, c, m

    def spy_next(self):
        n_next[0] += 1
        if n_next[0] == 2:
            torch.cuda.synchronize()
            marks["start"] = time.perf_counter()
        return next_batch(self)

    def spy_save(self, suffix=""):
        if suffix == "final":
            marks["end"] = time.perf_counter()
        return save(self, suffix)

    def log(line):
        print(line, flush=True)

    steplib.HEAD_DELTA["gaussian_yolo"] = spy_delta
    loaderlib.DetectionLoader.next = spy_next
    trainerlib.DetectorTrainer.save = spy_save
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kfr.launches = qm.launches = 0
    t0 = time.perf_counter()
    try:
        trainerlib.train_detector(
            data, cfg, max_iters=GAUSS_TRAIN_ITERS, device=DEVICE,
            loader_processes=TRAIN_LOADER_PROCS,
            log=log,
            metrics_path=os.path.join(root, "metrics.jsonl"))
    finally:
        steplib.HEAD_DELTA["gaussian_yolo"] = delta
        loaderlib.DetectionLoader.next = next_batch
        trainerlib.DetectorTrainer.save = save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (kfr.launches, qm.launches)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(root, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    losses = [r["loss"] for r in rows]
    uc = [float(v) for v in uc]
    net_cfg = quiet_graph(cfg_text, train=True).net
    n_img = net_cfg.optimizer_batch
    per_iter = [n_img / r["imgs_per_sec"] for r in rows]
    e2e = (GAUSS_TRAIN_ITERS - 1) * n_img / (marks["end"] - marks["start"])
    print(f"train gaussian-yolov3-{GAUSS_PX} batch={n_img} subdivisions="
          f"{net_cfg.subdiv} "
          f"(bf16, act16), {GAUSS_TRAIN_ITERS} iterations on "
          f"{GAUSS_TRAIN_IMAGES} synth images ({synth_s:.1f} s to write): "
          f"losses {', '.join(f'{v:.4f}' for v in losses)}; s/iter by "
          f"the trainer's clock {', '.join(f'{v:.3f}' for v in per_iter)}"
          f"; end to end over iterations 2-{GAUSS_TRAIN_ITERS}: "
          f"{(GAUSS_TRAIN_ITERS - 1) * n_img} images in "
          f"{marks['end'] - marks['start']:.3f} s, {e2e:.2f} img/s; "
          f"buckets {[r['dims'] for r in rows]}; "
          f"uc_loss over {len(uc)} head deltas {min(uc):.4g} to "
          f"{max(uc):.4g}; peak memory {peak / 2**30:.2f} GiB; wall "
          f"{wall:.1f} s; region launches {launches[0]}, int8 "
          f"{launches[1]} [{card}]", flush=True)
    require(launches == (0, 0), "training launches neither kernel")
    require(len(losses) == GAUSS_TRAIN_ITERS and all(np.isfinite(losses)),
            f"finite losses {losses}")
    require(len(uc) == GAUSS_TRAIN_ITERS * net_cfg.subdiv * 3
            and all(np.isfinite(uc)),
            "a finite uc_loss from every head and micro-batch")
    final = os.path.join(backup, "gaussian_final.weights")
    trained, seen, _v = wio.load_weights(quiet_graph(cfg_text), final)
    moved = sum(float(np.abs(p["mean"]).max()) > 0 for p in trained
                if "mean" in p)
    ck = np.load(os.path.join(backup, "gaussian_last.ckpt.npz"))
    mom = sum(float(np.abs(ck[k]).max()) > 0 for k in ck.files
              if k.startswith("opt/u/") and k.endswith("/w"))
    print(f"gaussian trained: seen {seen}, rolling means moved in {moved} "
          f"layers, momentum nonzero in {mom} conv weights", flush=True)
    require(seen == GAUSS_TRAIN_ITERS * n_img and moved == 72 and mom == 75,
            "moved rolling statistics and nonzero momentum buffers")


def gaussian_valid(card, root):
    """Phase 11 (e): `-mode valid` of the CLI over GAUSS_VALID_IMAGES synth
    images, f32, batch 8, on probe weights whose threshold .005 sits in a
    gap of the whole set's objectness logits: one region launch a batch,
    a MapResult equal to the plain path's, the prediction rate."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.apps import cli
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.data.image import (load_image_rgb,
                                              resize_image_darknet)
    from darknet_tpu_torch.eval import map as maplib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.weights import io as wio

    files = synth.generate(os.path.join(root, "valid"), n_train=0,
                           n_val=GAUSS_VALID_IMAGES, seed=3)
    names = os.path.join(root, "valid.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), GAUSS_CLASSES)]) + "\n")
    data = os.path.join(root, "valid.data")
    with open(data, "w") as f:
        f.write(f"classes = {GAUSS_CLASSES}\nvalid = {files['val_list']}\n"
                f"names = {names}\n")
    cfg_text = gaussian_cfg(GAUSS_PX)
    cfg = os.path.join(root, "valid.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    x = np.stack([resize_image_darknet(load_image_rgb(p), GAUSS_PX,
                                       GAUSS_PX) for p in files["val_paths"]])
    weights = os.path.join(root, "valid.weights")
    npar = gaussian_probe(g, x, VALID_THRESH, VALID_PASS * len(x))
    wio.save_weights(g, unfolded(g, npar), weights)
    del x

    runs = []
    validate_detector = maplib.validate_detector

    def spy_validate(net, *a, **kw):
        kfr.launches = qm.launches = 0
        res = validate_detector(net, *a, **kw)
        runs.append({"net": net, "res": res, "region": kfr.launches,
                     "int8": qm.launches})
        return res

    maplib.validate_detector = spy_validate
    try:
        t0 = time.perf_counter()
        cli.main(["-mode", "valid", "-data_file", data, "-model_file", cfg,
                  "-weights_file", weights, "-device", DEVICE])
        wall = time.perf_counter() - t0
        f32 = runs[-1]
        plain = Network(f32["net"].graph, f32["net"].params, device=DEVICE,
                        fuse_regions="plain")
        spy_validate(plain, files["val_paths"], GAUSS_CLASSES,
                     batch=VALID_BATCH, resize="darknet", progress=False)
    finally:
        maplib.validate_detector = validate_detector
    a, p = f32["res"], runs[-1]["res"]
    batches = GAUSS_VALID_IMAGES // VALID_BATCH
    print(f"valid gaussian-yolov3-{GAUSS_PX} f32 (-mode valid, "
          f"{GAUSS_VALID_IMAGES} images): mAP@0.5 {a.map!r} (plain "
          f"{p.map!r}), predictions {a.n_pred} ({p.n_pred}), GT {a.n_gt}; "
          f"prediction {a.imgs_per_s:.2f} img/s ({a.pred_time_s:.3f} s), "
          f"whole call {GAUSS_VALID_IMAGES / wall:.2f} img/s; region "
          f"launches {f32['region']} (plain {runs[-1]['region']}), int8 "
          f"{f32['int8']} [{card}]", flush=True)
    require(f32["region"] == batches and runs[-1]["region"] == 0,
            f"one region launch a batch of {VALID_BATCH}: {f32['region']}")
    require(a.n_gt == p.n_gt > 0 and a.n_pred == p.n_pred > 0
            and a.map == p.map, "the kernel path's MapResult equals the "
            "plain path's")


def v1_request(net, frame):
    """One YOLOv1 request through the public API: the heads (host numpy),
    and the [detection] decode of the first (`ops/detection_v1`), as the
    JAX package serves a v1 head."""
    import torch

    from darknet_tpu_torch.ops.detection_v1 import detection_decode

    heads, _dec = net.forward_heads(frame)
    return heads, detection_decode(
        torch.from_numpy(heads[0]).reshape(len(frame), -1),
        net.graph.layers[-1])


def rel_err(got, want) -> tuple:
    """(max |got - want| over max |want|, max |want|) of two host arrays
    or CPU tensors (`held_to_plain`'s measure)."""
    import torch

    err, scale, _share, _ok = held_to_plain(torch.as_tensor(got),
                                            torch.as_tensor(want), 0.0)
    return err / max(scale, 1e-30), scale


def phase_v1(card):
    """Phase 12: YOLOv1-448 (pjreddie's yolov1.cfg, `yolov1_cfg`) served
    in f32, bf16 and int8 and trained at its published batch, and the
    rare layer kinds on narrow cfgs, the data and saves under a temporary
    directory."""
    root = tempfile.mkdtemp(prefix="chip_smoke_v1_")
    try:
        t0 = time.perf_counter()
        bf16_img_s = v1_serve(card)
        v1_int8(card, bf16_img_s)
        v1_train(card, root)
        v1_rare(card)
        print(f"phase 12 (YOLOv1 and the rare kinds) took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def v1_serve(card):
    """Phase 12 (a): YOLOv1-448 at b=8 on random weights (numpy seed 0):
    f32 heads on the card against the port's own CPU run, bf16 heads
    finite and near the f32 heads, the [detection] decode on the card
    against the CPU's, detect_batch's eight empty lists, the device
    path's ValueError, no kernel launch, and the bf16 rate.  Returns the
    bf16 img/s."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.ops.detection_v1 import detection_decode

    g = quiet_graph(yolov1_cfg(V1_PX))
    t0 = time.perf_counter()
    raw = paramlib.init_params(g, seed=0)
    n_params = sum(v.size for p in raw for v in p.values())
    npar = paramlib.fuse_conv_batchnorm(g, raw)
    del raw
    init_s = time.perf_counter() - t0
    nets = {name: Network(g, paramlib.params_to_torch(g, npar, dev, dt),
                          compute_dtype=dt, device=dev)
            for name, dev, dt in (("cpu", "cpu", torch.float32),
                                  ("f32", DEVICE, torch.float32),
                                  ("bf16", DEVICE, torch.bfloat16))}
    del npar
    kinds = [l.kind for l in g.layers]
    print(f"yolov1-{V1_PX}: {len(kinds)} layers "
          f"({kinds.count('convolutional')} convs, "
          f"{kinds.count('maxpool')} maxpools, then "
          f"{', '.join(kinds[-4:])}), {n_params:,} params "
          f"({4 * n_params / 1e6:.1f} MB f32, init {init_s:.1f} s), "
          f"{g.total_bflops:.2f} BFLOP an image; region plans "
          f"{len(nets['f32']._fwd.region_plans)}", flush=True)
    rng = np.random.default_rng(20)
    frame = rng.uniform(0, 1, (SERVE_BATCH, V1_PX, V1_PX, 3)).astype(
        np.float32)
    kfr.launches = qm.launches = 0
    heads = {k: net.forward_heads(frame)[0][0] for k, net in nets.items()}
    launches = (kfr.launches, qm.launches)
    f32_err, scale = rel_err(heads["f32"], heads["cpu"])
    bf_err, _ = rel_err(heads["bf16"], heads["f32"])
    l = g.layers[-1]
    with torch.inference_mode():
        r = nets["f32"]._fwd(nets["f32"].params,
                             torch.from_numpy(frame).to(DEVICE))
        on_card = detection_decode(r["heads"][0].reshape(SERVE_BATCH, -1), l)
    on_cpu = detection_decode(torch.from_numpy(heads["cpu"]).reshape(
        SERVE_BATCH, -1), l)
    dec_err = max(rel_err(a.cpu(), b)[0] for a, b in zip(on_card, on_cpu))
    empty = nets["f32"].detect_batch(frame, thresh=0.0)
    try:
        nets["f32"].submit_detect_device(frame)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"serve yolov1-{V1_PX} b={SERVE_BATCH}: heads {heads['f32'].shape};"
          f" f32 card against CPU {f32_err:.3g} of the scale {scale:.4g}; "
          f"bf16 against f32 {bf_err:.3g}; decode card against CPU "
          f"{dec_err:.3g}; detect_batch {empty}; device path: {refused!r}; "
          f"region launches {launches[0]}, int8 {launches[1]} [{card}]",
          flush=True)
    require(np.isfinite(heads["bf16"]).all() and np.isfinite(
        heads["f32"]).all() and scale > 0, "finite YOLOv1 heads")
    require(f32_err <= TOL_F32 and dec_err <= 2 * TOL_F32,
            "the f32 heads and decode on the card agree with the CPU's")
    require(bf_err <= V1_TOL_BF16, "the bf16 heads within "
            f"{V1_TOL_BF16} of the f32 heads' scale")
    require(empty == [[]] * SERVE_BATCH and "detection" in refused,
            "no host detections and the device path refused, as in the "
            "JAX package")
    require(launches == (0, 0), "YOLOv1 plans no region and quantizes "
            "nothing in floating point")
    net = nets["bf16"]
    del nets
    x = torch.from_numpy(frame).to(DEVICE)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: net._fwd(net.forward_params, x), iters=5)
    trace_summary(lambda: v1_request(net, frame), "yolov1 bf16 request", card)
    img_s, spread, rates = serve_rate(
        net, frame, request=lambda: v1_request(net, frame))
    print(f"serving yolov1-{V1_PX} bf16 b={SERVE_BATCH}: forward {fwd_ms:.3f}"
          f" ms (CUDA events); {img_s:.2f} img/s median of {RATE_WINDOWS} "
          f"windows of {RATE_REQUESTS} requests "
          f"({', '.join(f'{r:.2f}' for r in rates)}; spread "
          f"{100 * spread:.2f}%), heads to the host and decoded there "
          f"[{card}]", flush=True)
    return img_s


def v1_int8(card, bf16_img_s):
    """Phase 12 (b): int8 YOLOv1-448 (bf16 between the layers): a dynamic
    request (V1_INT8_CONVS int8 launches), calibrate_int8 on
    INT8_CALIB_FRAMES frames, a calibrated request with every quantized
    conv's output bitwise equal to the plain version on the same int8
    operands, and the int8 rate."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.ops import quant_matmul as qm

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(yolov1_cfg(V1_PX), seed=0,
                               compute_dtype=torch.bfloat16, device=DEVICE,
                               int8=True)
    n_q = sum("w_q" in p for p in net.params)
    rng = np.random.default_rng(21)
    shape = (SERVE_BATCH, V1_PX, V1_PX, 3)
    frame = rng.uniform(0, 1, shape).astype(np.float32)
    qm.launches = 0
    heads, _dec = v1_request(net, frame)
    dynamic = qm.launches
    net.calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(np.float32)
                        for _ in range(INT8_CALIB_FRAMES)])
    records = []
    orig = convmod.int8_conv

    def recorded(x_q, w_q, ws, bias, xs, **kw):
        y = orig(x_q, w_q, ws, bias, xs, **kw)
        records.append(((x_q, w_q, ws, bias, xs), kw, y))
        return y

    qm.launches = 0
    convmod.int8_conv = recorded
    try:
        heads_cal, _dec = v1_request(net, frame)
    finally:
        convmod.int8_conv = orig
    calibrated, n_rec = qm.launches, len(records)
    n_eq = sum(bool(torch.equal(y, qm.int8_conv_plain(*ops, **kw)))
               for ops, kw, y in records)
    del records
    print(f"yolov1 int8: {n_q} quantized convs; int8 launches a request: "
          f"dynamic {dynamic}, calibrated {calibrated}; {n_eq} of {n_rec} "
          f"quantized convs bitwise equal to the plain version", flush=True)
    require(n_q == V1_INT8_CONVS and dynamic == calibrated == n_rec == n_eq
            == n_q, f"{V1_INT8_CONVS} int8 launches a request, each "
            f"bitwise equal to its plain version")
    require(np.isfinite(heads[0]).all() and np.isfinite(heads_cal[0]).all(),
            "finite int8 heads")
    trace_summary(lambda: v1_request(net, frame), "yolov1 int8 request", card)
    img_s, spread, rates = serve_rate(
        net, frame, request=lambda: v1_request(net, frame))
    print(f"serving yolov1-{V1_PX} int8 (calibrated, bf16) b={SERVE_BATCH}: "
          f"{img_s:.2f} img/s median of {RATE_WINDOWS} windows of "
          f"{RATE_REQUESTS} requests "
          f"({', '.join(f'{r:.2f}' for r in rates)}; spread "
          f"{100 * spread:.2f}%) beside bf16 {bf16_img_s:.2f} img/s "
          f"[{card}]", flush=True)


def v1_train(card, root):
    """Phase 12 (c): parity of the narrow YOLOv1 on the card against the
    port's CPU run (phase 8 (a)'s form, generator None), then
    train_detector on YOLOv1-448 at its published batch=64,
    subdivisions=8, bf16 (act16), on synth images for V1_TRAIN_ITERS
    iterations, the dropout drawn from the trainer's generator: finite
    losses, moved rolling statistics, nonzero momentum buffers (the
    [local] and [connected] weights among them), no kernel launch; s/iter,
    img/s, peak memory; the saved .weights served beside the trained
    params folded, equal heads."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.data import loader as loaderlib
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.train import trainer as trainerlib

    phase_train_parity((("narrow YOLOv1 64 px", NARROW_V1_CFG,
                         V1_PARITY_SEED, False),))

    t0 = time.perf_counter()
    files = synth.generate(os.path.join(root, "train"),
                           n_train=V1_TRAIN_IMAGES, n_val=2, seed=2,
                           size_range=TRAIN_IMAGE_PX)
    synth_s = time.perf_counter() - t0
    cfg_text = yolov1_cfg(V1_PX)
    cfg = os.path.join(root, "yolov1.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    names = os.path.join(root, "voc.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), V1_CLASSES)]) + "\n")
    backup = os.path.join(root, "backup")
    data = os.path.join(root, "voc.data")
    with open(data, "w") as f:
        f.write(f"classes = {V1_CLASSES}\ntrain = {files['train_list']}\n"
                f"names = {names}\nsave = {backup}\n")

    marks, n_next = {}, [0]
    next_batch = loaderlib.DetectionLoader.next
    save = trainerlib.DetectorTrainer.save

    def spy_next(self):
        n_next[0] += 1
        if n_next[0] == 2:
            torch.cuda.synchronize()
            marks["start"] = time.perf_counter()
        return next_batch(self)

    def spy_save(self, suffix=""):
        if suffix == "final":
            marks["end"] = time.perf_counter()
            trained.append(paramlib.train_params_to_numpy(self.graph,
                                                          self.params))
            mom.extend(l.kind for l, u in zip(self.graph.layers,
                                             self.opt_state["u"])
                       if "w" in u and float(u["w"].abs().max()) > 0)
        return save(self, suffix)

    trained, mom = [], []
    loaderlib.DetectionLoader.next = spy_next
    trainerlib.DetectorTrainer.save = spy_save
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kfr.launches = qm.launches = 0
    t0 = time.perf_counter()
    try:
        trainerlib.train_detector(
            data, cfg, max_iters=V1_TRAIN_ITERS, device=DEVICE,
            loader_processes=TRAIN_LOADER_PROCS,
            log=lambda line: print(line, flush=True),
            metrics_path=os.path.join(root, "metrics.jsonl"))
    finally:
        loaderlib.DetectionLoader.next = next_batch
        trainerlib.DetectorTrainer.save = save
    torch.cuda.synchronize()
    done = time.perf_counter()
    wall = done - t0
    launches = (kfr.launches, qm.launches)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(root, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if '"loss"' in line]
    losses = [r["loss"] for r in rows]
    net_cfg = quiet_graph(cfg_text, train=True).net
    n_img = net_cfg.optimizer_batch
    per_iter = [n_img / r["imgs_per_sec"] for r in rows]
    span = marks["end"] - marks["start"]
    e2e = (V1_TRAIN_ITERS - 1) * n_img / span
    print(f"train yolov1-{V1_PX} batch={n_img} subdivisions="
          f"{net_cfg.subdiv} (bf16, act16), {V1_TRAIN_ITERS} iterations on "
          f"{V1_TRAIN_IMAGES} synth images ({synth_s:.1f} s to write): "
          f"losses {', '.join(f'{v:.4f}' for v in losses)}; s/iter by the "
          f"trainer's clock {', '.join(f'{v:.3f}' for v in per_iter)}; end "
          f"to end over iterations 2-{V1_TRAIN_ITERS}: "
          f"{(V1_TRAIN_ITERS - 1) * n_img} images in {span:.3f} s, "
          f"{e2e:.2f} img/s; peak memory {peak / 2**30:.2f} GiB; wall "
          f"{wall:.1f} s, of which the final saves (.weights and the "
          f"state) {done - marks['end']:.1f} s; region launches "
          f"{launches[0]}, int8 {launches[1]} [{card}]", flush=True)
    require(launches == (0, 0), "training launches neither kernel")
    require(len(losses) == V1_TRAIN_ITERS and all(np.isfinite(losses)),
            f"finite losses {losses}")

    g = quiet_graph(cfg_text)
    trained = trained[0]
    moved = sum(float(np.abs(p["mean"]).max()) > 0 for p in trained
                if "mean" in p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served = Network.from_cfg(cfg_text, weights=os.path.join(
            backup, "yolov1_final.weights"), device=DEVICE)
    folded = Network(g, paramlib.params_to_torch(
        g, paramlib.fuse_conv_batchnorm(g, trained), DEVICE), device=DEVICE)
    x = np.random.default_rng(22).uniform(
        0, 1, (SERVE_BATCH, V1_PX, V1_PX, 3)).astype(np.float32)
    a, b = served.forward_heads(x)[0][0], folded.forward_heads(x)[0][0]
    print(f"yolov1 trained: seen {served.seen}, rolling means moved in "
          f"{moved} layers, momentum nonzero in {len(mom)} weights "
          f"({mom.count('local')} local, {mom.count('connected')} "
          f"connected); the saved .weights serve heads equal to the trained "
          f"params folded: {bool(np.array_equal(a, b))}", flush=True)
    require(served.seen == V1_TRAIN_ITERS * n_img and moved == 24
            and len(mom) == 26 and "local" in mom and "connected" in mom,
            "moved rolling statistics and nonzero momentum buffers")
    require(np.array_equal(a, b) and np.isfinite(a).all(),
            "the trained .weights serve what the trained params serve")


def v1_rare(card):
    """Phase 12 (d): the rare-kind cfgs (RARE_KINDS_CFG, RARE_COST_CFG)
    served in f32 on the card through the region kernel (one launch a
    request), held to the plain region on the card and to the CPU; a
    training step of each on the card against the CPU (phase 8 (a)'s
    form); an int8 network whose antialiased conv quantizes, its int8
    launch bitwise equal to the plain version."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    rng = np.random.default_rng(23)
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    for name, cfg in (("rare kinds", RARE_KINDS_CFG),
                      ("[crop] + [cost]", RARE_COST_CFG)):
        g = quiet_graph(cfg)
        raw = paramlib.init_params(g, seed=0)
        for p in raw:
            if "scales" in p:
                p["scales"] = p["scales"] * np.float32(1.5)
        npar = paramlib.fuse_conv_batchnorm(g, raw)
        out, launched = {}, {}
        for k, dev, mode in (("cpu", "cpu", "hybrid"),
                             ("kernel", DEVICE, "hybrid"),
                             ("plain", DEVICE, "plain")):
            net = Network(g, paramlib.params_to_torch(g, npar, dev),
                          device=dev, fuse_regions=mode)
            kfr.launches = 0
            out[k] = net.predict(x)
            launched[k] = kfr.launches
        k_err, scale = rel_err(out["kernel"], out["plain"])
        c_err, _ = rel_err(out["kernel"], out["cpu"])
        print(f"{name} 64 px f32: output {out['kernel'].shape}, kernel path "
              f"against the plain region {k_err:.3g} and against the CPU "
              f"{c_err:.3g} of the scale {scale:.4g}; region launches "
              f"{launched['kernel']} (plain {launched['plain']}) [{card}]",
              flush=True)
        require(launched["kernel"] == 1 and launched["plain"] == 0,
                f"{name}: one region launch a request")
        require(np.isfinite(out["kernel"]).all() and k_err <= TOL_F32
                and c_err <= TOL_F32, f"{name}: the card serves what the "
                f"plain region and the CPU serve")
    phase_train_parity((("rare kinds 64 px", RARE_KINDS_CFG,
                         RARE_PARITY_SEED, False),
                        ("[crop] + [cost] 64 px", RARE_COST_CFG,
                         RARE_PARITY_SEED, False)))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(RARE_KINDS_CFG, seed=0, int8=True,
                               compute_dtype=torch.bfloat16, device=DEVICE)
    quantized = [i for i, p in enumerate(net.params) if "w_q" in p]
    records = []
    orig = convmod.int8_conv

    def recorded(x_q, w_q, ws, bias, xs, **kw):
        y = orig(x_q, w_q, ws, bias, xs, **kw)
        records.append(((x_q, w_q, ws, bias, xs), kw, y))
        return y

    qm.launches = kfr.launches = 0
    convmod.int8_conv = recorded
    try:
        y = net.predict(x)
    finally:
        convmod.int8_conv = orig
    n_eq = sum(bool(torch.equal(r, qm.int8_conv_plain(*ops, **kw)))
               for ops, kw, r in records)
    print(f"rare kinds int8 (bf16): quantized convs {quantized} (layer 10 "
          f"antialiased: {bool(net.graph.layers[10].antialiasing)}); int8 "
          f"launches {qm.launches}, {n_eq} bitwise equal to the plain "
          f"version; region launches {kfr.launches}", flush=True)
    require(quantized == [10] and net.graph.layers[10].antialiasing
            and qm.launches == len(records) == n_eq == 1
            and kfr.launches == 1 and np.isfinite(y).all(),
            "the antialiased conv runs the int8 kernel, bitwise equal to "
            "the plain version")


CLI_BENCH_BATCH = 8        # phase 13 (a): -mode bench at b=8, no training
REGION_INT8_CONVS = 107    # INT8_CONVS + the 16 region convs without w_q
CLI_RATE = dict(warmup=2, windows=2, requests=10)
CLI_VALID_IMAGES = 8
CLI_SHOW_TRAIN = 8         # phase 13 (f): images, two batches of 4
TOL_TRACE = 0.10           # the trace report against CUDA events


def captured(fn, *args):
    """fn(*args) with its standard output caught: (result, lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def table_rows(lines):
    """The rows of a trace_report table: {scope: ms}, TOTAL, the trace's
    device time and its line of launches with their kernel."""
    rows, device, kernels = {}, None, None
    start = next(i for i, ln in enumerate(lines) if ln.startswith("layer "))
    end = next(i for i in range(start, len(lines))
               if lines[i].startswith("TOTAL"))
    for ln in lines[start + 1:end]:
        parts = ln.split()
        rows[parts[0]] = float(parts[1])
    if end + 2 < len(lines) and lines[end + 1].startswith("device time"):
        device = float(lines[end + 1].split()[-1])
        kernels = lines[end + 2]
    return rows, float(lines[end].split()[-1]), device, kernels


def first_device_event():
    """A one-byte copy to the card, synchronised, first in a profile: a
    trace can lose its first device event (phase 11's one-launch profile
    of the region kernel lost it, and phase 13 (e) a batch's upload)."""
    import torch

    torch.ones(1, dtype=torch.int8).to(DEVICE)
    torch.cuda.synchronize()


def phase_cli(card):
    """Phase 13, the CLI's bench, -benchmark_layers, -dbg_sync and
    -show_imgs, region_int8 and the pinned bf16 uploads, with its own
    timing line."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return cli_phase(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)


def cli_phase(card, root):
    import contextlib

    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.apps import cli
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.data.image import (load_image_rgb,
                                              resize_image_darknet)
    from darknet_tpu_torch.data.loader import bf16_from_f32
    from darknet_tpu_torch.nn import emit as emitmod
    from darknet_tpu_torch.nn import params as tparams
    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.ops import fused_region as fr
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step
    from darknet_tpu_torch.train.trainer import PinnedUploader
    from darknet_tpu_torch.utils import debug, profiler
    from darknet_tpu_torch.weights import io as wio

    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    out = {}

    # (a) -mode bench through the CLI at b=8, counted: reset just before,
    # read just after
    kfr.launches = qm.launches = 0
    t = time.perf_counter()
    _r, lines = captured(cli.main, ["-mode", "bench", str(CLI_BENCH_BATCH),
                                    "--no-train"])
    bench = json.loads(lines[-1])
    print(lines[-1], flush=True)
    out["bench"] = (kfr.launches, qm.launches)
    print(f"(a) -mode bench b={CLI_BENCH_BATCH}: {time.perf_counter() - t:.1f}"
          f" s; launches over the run: region {kfr.launches}, int8 "
          f"{qm.launches}; a request: int8 {bench['launches_per_request']}, "
          f"bf16 {bench['bf16_launches_per_request']} [{card}]", flush=True)
    require(bench["value"] > 0 and bench["bf16_img_s"] > 0
            and bench["p50_latency_ms_batch1_sync"] > 0
            and bench["batch1_ms_amortized"] > 0, "positive bench rates")
    require(bench["launches_per_request"] == {
        "fused_region": 1, "int8_gemm": INT8_CONVS}, "1 region and "
        f"{INT8_CONVS} int8 launches an int8 bench request")
    require(bench["bf16_launches_per_request"] == {
        "fused_region": 1, "int8_gemm": 0}, "1 region launch a bf16 bench "
        "request")
    require("vs_baseline" not in bench and bench["card"] == card,
            "no vs_baseline; the card named")

    # (b) region_int8, calibrated, b=8
    t = time.perf_counter()
    rng = np.random.default_rng(13)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frame = rng.uniform(0, 1, shape).astype(np.float32)
    calib = [rng.uniform(0, 1, shape[1:]).astype(np.float32)
             for _ in range(INT8_CALIB_FRAMES)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg_text, seed=0, int8=True,
                               compute_dtype=torch.bfloat16, device=DEVICE)
        bnet = Network.from_cfg(cfg_text, seed=0,
                                compute_dtype=torch.bfloat16, device=DEVICE)
    net.calibrate_int8(calib)
    int8_rate = serve_rate(net, frame, **CLI_RATE)[0]
    net.calibrate_int8(calib, region_int8=True)
    n_scaled = sum("x_scale" in p for p in net.params)
    require(n_scaled == REGION_INT8_CONVS and not any(
        p.stem for p in net._fwd.region_plans.values()),
        f"{REGION_INT8_CONVS} calibrated convs, no stem: {n_scaled}")
    records = []
    orig_conv = convmod.int8_conv

    def recorded(x_q, w_q, ws, bias, xs, **kw):
        y = orig_conv(x_q, w_q, ws, bias, xs, **kw)
        records.append({"ops": (x_q, w_q, ws, bias, xs), "kw": kw, "out": y})
        return y

    convmod.int8_conv = recorded
    kfr.launches = qm.launches = 0
    try:
        got = net.submit_detect_device(frame)
        torch.cuda.synchronize()
    finally:
        convmod.int8_conv = orig_conv
    out["region_int8"] = (kfr.launches, qm.launches)
    require(out["region_int8"] == (0, REGION_INT8_CONVS),
            f"0 region and {REGION_INT8_CONVS} int8 launches a region_int8 "
            f"request, got {out['region_int8']}")
    n_eq, padded, err = 0, [], 0.0
    for r in records:
        ref = qm.int8_conv_plain(*r["ops"], **r["kw"])
        n_eq += bool(torch.equal(r["out"], ref))
        err = max(err, float((r["out"].float() - ref.float()).abs().max()))
        if min(r["ops"][0].shape[-1], r["ops"][1].shape[0]) < 128:
            padded.append(r)          # a region conv without its own w_q
        del r["out"]
    n_pad = sum(r["ops"][0].shape[-1] % 128 > 0 for r in padded)
    require(n_eq == len(records) == REGION_INT8_CONVS and len(padded) == 16,
            f"every int8 conv bitwise equal ({n_eq} of {len(records)}), 16 "
            f"new ({len(padded)})")
    convmod.int8_conv = qm.int8_conv_plain
    try:
        want = net.submit_detect_device(frame)
    finally:
        convmod.int8_conv = orig_conv
    require(all(torch.equal(a, b) for a, b in zip(got, want))
            and kept(got[2]) == kept(want[2]), "the region_int8 triple and "
            "kept set equal to the plain path's")
    with torch.inference_mode():
        pad_ms = sum(cuda_ms(lambda r=r: qm.int8_conv(*r["ops"], **r["kw"]),
                             iters=5, warmup=1) for r in padded)
        pad_plain = sum(cuda_ms(lambda r=r: qm.int8_conv_plain(
            *r["ops"], **r["kw"]), iters=3, warmup=1) for r in padded)
        req_ms, n_k = profiled_ms(lambda: net.submit_detect_device(frame),
                                  "int8_gemm_kernel")
    macs = sum(r["ops"][0].shape[0] * r["kw"]["out_hw"][0]
               * r["kw"]["out_hw"][1] * r["ops"][1].numel() for r in padded)
    padded_macs = sum(r["ops"][0].shape[0] * r["kw"]["out_hw"][0]
                      * r["kw"]["out_hw"][1] * r["ops"][1].shape[0]
                      * r["kw"]["size"] ** 2
                      * -(-r["ops"][0].shape[-1] // 128) * 128
                      for r in padded)
    del records, padded
    region_rate = serve_rate(net, frame, **CLI_RATE)[0]
    bf16_rate = serve_rate(bnet, frame, **CLI_RATE)[0]
    print(f"(b) region_int8 yolov4-{SERVE_PX} b={SERVE_BATCH}: "
          f"{REGION_INT8_CONVS} int8 launches a request, 0 region, every "
          f"launch bitwise equal to the plain version (max abs err {err}), "
          f"the triple equal to the plain path's; the 16 new convs "
          f"({n_pad} with C padded to 128) {pad_ms:.3f} ms by CUDA events "
          f"(plain {pad_plain:.3f} ms; {macs / 1e9:.3f} useful GMAC, "
          f"{padded_macs / 1e9:.3f} executed); int8 kernels over a "
          f"request {req_ms} ms "
          f"({n_k} kernels, profiler); img/s ({CLI_RATE['windows']} windows "
          f"of {CLI_RATE['requests']}): region_int8 {region_rate:.2f}, int8 "
          f"{int8_rate:.2f}, bf16 {bf16_rate:.2f}; "
          f"{time.perf_counter() - t:.1f} s [{card}]", flush=True)
    del net

    # (c) -benchmark_layers 1 in front of -mode valid (f32, the CLI's
    # network), then the same table for the bf16 network; probe weights
    # whose threshold sits in a gap of the set's logits, as in phase 9
    t = time.perf_counter()
    files = synth.generate(os.path.join(root, "data"), n_train=CLI_SHOW_TRAIN,
                           n_val=CLI_VALID_IMAGES, seed=2)
    names = os.path.join(root, "all.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), VALID_CLASSES)]) + "\n")
    data = os.path.join(root, "obj.data")
    with open(data, "w") as f:
        f.write(f"classes = {VALID_CLASSES}\ntrain = {files['train_list']}\n"
                f"valid = {files['val_list']}\nnames = {names}\n"
                f"save = {os.path.join(root, 'backup')}\n")
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    weights = os.path.join(root, "probe.weights")
    val = np.stack([resize_image_darknet(load_image_rgb(p), SERVE_PX,
                                         SERVE_PX)
                    for p in files["val_paths"]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pnet = Network(g, tparams.params_to_torch(g, probe_params(g),
                                                  DEVICE),
                       device=DEVICE, fuse_regions="plain")
    with torch.inference_mode():
        raw = pnet._fwd(pnet.params, torch.from_numpy(val).to(DEVICE))[
            "raw_heads"]
    bias = obj_bias_for(raw, VALID_THRESH, VALID_PASS * CLI_VALID_IMAGES)
    del pnet, raw
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)
    argv = ["-mode", "valid", "-data_file", data, "-model_file", cfg,
            "-weights_file", weights]
    _r, lines = captured(cli.main, argv + ["-benchmark_layers", "1"])
    rows, total, device, kernels = table_rows(lines)
    convs = {f"L{l.index:03d}_convolutional" for l in g.layers
             if l.kind == "convolutional" and l.index > 23}
    report = [ln for ln in lines if ln.startswith((" # of", " Recall",
                                                   " Precision", " cid",
                                                   " mAP"))]
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:10]
    print("(c) -benchmark_layers 1 -mode valid f32, the top ten rows: "
          + "; ".join(f"{k} {v:.3f}" for k, v in top)
          + f"; TOTAL {total} ms, the trace's device time {device} ms, "
          f"{len(rows)} rows; {kernels} [{card}]", flush=True)
    require("L000-023_region" in rows and convs <= set(rows),
            f"a row for the region and every conv: missing "
            f"{sorted(convs - set(rows))[:5]}")
    require(device and abs(total - device) <= TOL_TRACE * device,
            f"TOTAL {total} within 10% of the trace's device time {device}")

    def region_kernel_check(rnet, label, kernel):
        """The region row's kernel time in a trace against the kernel's
        CUDA-event time on the same input (b=1)."""
        from torch.profiler import ProfilerActivity, profile

        x1 = torch.from_numpy(val[:1]).to(DEVICE)
        with torch.inference_mode():
            rnet._fwd(rnet.params, x1)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                first_device_event()
                for _ in range(5):
                    rnet._fwd(rnet.params, x1)
                torch.cuda.synchronize()
            ks = [e.time_range.elapsed_us() for e in
                  profiler.device_events(prof.events()) if kernel in e.name]
            per = profiler.attribute(prof.events(), True)
            # per launch in the trace: a dropped event would not count
            k_ms = sum(us for name, us in per["L000-023_region"].items()
                       if kernel in name) / max(len(ks), 1) / 1e3
            plan = rnet._fwd.region_plans[0]
            sub, k = fr.hybrid_prefix(plan)
            ws, bs = fr.step_weights(sub.steps, rnet.params,
                                     rnet.compute_dtype or torch.float32)
            cd = rnet.compute_dtype or torch.float32
            xc = x1.to(cd)

            def call():
                kfr.region_call(sub, xc, ws, bs, compute_dtype=cd)
            loop_ms = cuda_ms(call, iters=10)
            ev_ms = graph_ms(call, reps=10)
        print(f"(c) {label}: the region row's {kernel} {k_ms:.4f} ms a "
              f"launch in the trace ({len(ks)} of 5 launches); by CUDA events {ev_ms:.4f} ms over CUDA-graph "
              f"replays, {loop_ms:.4f} ms over a loop of launches [{card}]",
              flush=True)
        require(abs(k_ms - ev_ms) <= TOL_TRACE * ev_ms,
                f"{label}: the trace's region kernel within 10% of its "
                f"CUDA-event time")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fnet = Network.from_cfg(cfg, weights=weights, device=DEVICE)
    region_kernel_check(fnet, "f32", "region_kernel")
    del fnet
    region_kernel_check(bnet, "bf16", "region_tc_kernel")
    blines = []
    x1 = torch.from_numpy(val[:1]).to(DEVICE)
    with torch.inference_mode():
        profiler.trace_report(
            lambda p, x: sum(h.float().sum()
                             for h in bnet._fwd(p, x)["heads"]),
            bnet.params, x1, graph=bnet.graph, log=blines.append, top=10)
    brows, btotal, bdevice, bkernels = table_rows(blines)
    print("(c) bf16 per-layer report, the top ten rows: " + "; ".join(
        f"{k} {v:.3f}" for k, v in list(brows.items())[:10])
        + f"; TOTAL {btotal} ms, the trace's device time {bdevice} ms; "
        f"{bkernels} [{card}]", flush=True)
    require(bdevice and abs(btotal - bdevice) <= TOL_TRACE * bdevice,
            "bf16 TOTAL within 10% of the trace's device time")

    # the profiler ranges are free when nothing profiles: the request rate
    # with them and with them stubbed out, in turns
    scoped = emitmod.scope
    with_s, without = [], []
    for turn in (0, 1):
        emitmod.scope = scoped if turn == 0 else (
            lambda name: contextlib.nullcontext())
        try:
            (with_s if turn == 0 else without).append(
                serve_rate(bnet, frame, **CLI_RATE)[0])
        finally:
            emitmod.scope = scoped
    print(f"(c) bf16 img/s with the profiler ranges {with_s}, without "
          f"{without}; {time.perf_counter() - t:.1f} s [{card}]", flush=True)
    t = time.perf_counter()

    # (d) -dbg_sync: the same results; a planted NaN named by its layer
    with torch.inference_mode():
        want = bnet.submit_detect_device(frame)
        for level in (1, 2):
            with debug.debug_sync_mode():
                if level == 2:
                    with debug.debug_nans():
                        got = bnet.submit_detect_device(frame)
                else:
                    got = bnet.submit_detect_device(frame)
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"-dbg_sync {level}: the same triple")
    bnet.params = [dict(p) for p in bnet.params]
    w = bnet.params[25]["w"].clone()
    w[0, 0, 0, 0] = float("nan")
    bnet.params[25]["w"] = w
    try:
        with debug.debug_sync_mode(), debug.debug_nans():
            bnet.submit_detect_device(frame)
        raised = ""
    except FloatingPointError as e:
        raised = str(e)
    require("L025_convolutional" in raised, f"a NaN in layer 25 named in "
            f"serving: {raised!r}")
    tg = quiet_graph(TRAIN_CSP_CFG, train=True)
    p0 = tparams.init_params(tg, seed=0)
    p0[2]["w"][0, 0, 0, 0] = np.nan
    params = tparams.train_params_to_torch(tg, p0, DEVICE)
    bx, by = train_batch(tg, 4, 1)
    try:
        with debug.debug_sync_mode(), debug.debug_nans():
            make_train_step(tg)(params, init_opt_state(tg, params),
                                torch.from_numpy(bx).to(DEVICE),
                                torch.from_numpy(by).to(DEVICE), 1e-3)
        raised_t = ""
    except FloatingPointError as e:
        raised_t = str(e)
    require("L002_convolutional" in raised_t, f"a NaN in layer 2 named in "
            f"a training step: {raised_t!r}")
    _r, dlines = captured(cli.main, argv + ["-dbg_sync", "2"])
    dreport = [ln for ln in dlines if ln.startswith((
        " # of", " Recall", " Precision", " cid", " mAP"))]
    require(dreport == report and report, "-mode valid -dbg_sync 2 prints "
            "the report of the run without")
    print(f"(d) -dbg_sync 1 and 2: the same triples and valid report; a NaN "
          f"named in serving ({raised!r}) and in a step ({raised_t!r}); "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    del bnet

    # (e) yolov4-608 training at batch 64, subdivisions 8, bf16/act16: the
    # first step from the f32 batch and from its bf16 cast through the
    # pinned staging buffers, bitwise; the H2D bytes of each profiled
    # iteration (phase 8 gives the end-to-end rate)
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()

    gt = quiet_graph(cfg_text, train=True)
    n_img, accum = gt.net.optimizer_batch, gt.net.subdiv
    tp0 = tparams.init_params(gt, seed=0)
    tx, ty = train_batch(gt, n_img, 7)
    step = make_train_step(gt, compute_dtype=torch.bfloat16, accum=accum,
                           train_act_dtype=torch.bfloat16)
    # the profiler's events carry no byte counts here, and its traces
    # lose events (the uploads among them in calls where a whole step was
    # traced), so the bytes are the uploaders' counts of what they copied;
    # a trace of the uploads alone shows the copies' kind (pinned,
    # asynchronous) and device time where it keeps them
    firsts, sent, copies = [], [], []
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())
    for batch in (tx, bf16_from_f32(tx)):
        params = tparams.train_params_to_torch(gt, tp0, DEVICE)
        opt = init_opt_state(gt, params)
        ux, uy = PinnedUploader(DEVICE), PinnedUploader(DEVICE)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            first_device_event()
            xt, yt = ux(batch), uy(ty)
            torch.cuda.synchronize()
        sent.append(ux.bytes + uy.bytes)
        copies.append([round(e.time_range.elapsed_us() / 1e3, 4)
                       for e in profiler.device_events(prof.events())
                       if e.name.startswith("Memcpy HtoD (Pinned")])
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            params, opt, cost, _m = step(params, opt, xt, yt, 1e-4)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = prev[0]
            torch.use_deterministic_algorithms(prev[1])
        del prof, xt, yt
        firsts.append((params, float(cost)))
        del opt
    same = firsts[0][1] == firsts[1][1] and all(
        torch.equal(a[k], b[k]) for a, b in zip(firsts[0][0], firsts[1][0])
        for k in a)
    print(f"(e) yolov4-{SERVE_PX} batch {n_img} subdivisions {accum} bf16 "
          f"act16: the first step from the f32 and the bf16 upload bitwise "
          f"equal: {same} (costs {firsts[0][1]}, {firsts[1][1]}); an "
          f"iteration's uploads by the uploaders' counts: f32 {sent[0]} "
          f"bytes, bf16 {sent[1]} (the images {tx.nbytes} and {tx.nbytes // 2}, the "
          f"truths {ty.nbytes}); the pinned copies' ms in a trace of the "
          f"uploads: f32 {copies[0]}, bf16 {copies[1]}; "
          f"{time.perf_counter() - t:.1f} s [{card}]", flush=True)
    require(same, "the first step bitwise equal from either upload")
    require(sent[0] - sent[1] == tx.nbytes // 2
            and sent[1] == tx.nbytes // 2 + ty.nbytes,
            "the uploads' bytes halved")
    del firsts

    # (f) -show_imgs in -mode train: three PNGs a batch
    t = time.perf_counter()
    tcfg = os.path.join(root, "narrow.cfg")
    with open(tcfg, "w") as f:
        f.write(TRAIN_CSP_CFG.replace("burn_in=0", "burn_in=0\nmax_epoch=1"))
    tdata = os.path.join(root, "train.data")
    show = os.path.join(root, "show")
    with open(files["data"]) as f, open(tdata, "w") as fo:
        fo.write(f.read() + f"save = {show}\n")
    captured(cli.main, ["-mode", "train", "-data_file", tdata, "-model_file",
                        tcfg, "-weights_file", "none", "-show_imgs",
                        "-no_calc_map", "-loader_processes", "0"])
    shown = sorted(n for n in os.listdir(show) if n.startswith("aug_"))
    print(f"(f) -show_imgs: {len(shown)} PNGs ({shown[:3]}); "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    require(len(shown) >= 6 and len(shown) % 3 == 0
            and shown[:3] == ["aug_00001.png", "aug_00002.png",
                              "aug_00003.png"], "three PNGs a batch")
    return out


# phase 14: the serving artifact (Network.export_serving) of yolov4-608
# at b=8, loaded in a child process that imports only darknet_tpu_torch;
# the rates of the artifact against eager serving (1 window of 20
# requests each way, interleaved), the op dispatch's host cost, the C ABI
# twin and the walkthrough twins at their test sizes
EXPORT_RATE = dict(warmup=2, windows=1, requests=10)
EXPORT_ROUNDS = 1         # windows each way, eager and artifact in turns
EXPORT_CHILD_REQUESTS = 2
DISPATCH_CALLS = 200
EXPORT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from darknet_tpu_torch.nn.network import Network, load_exported_serving
from darknet_tpu_torch.ops import quant_matmul as qm
from darknet_tpu_torch.ops.cuda import fused_region as kfr

art, frames, out, reps = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
x = np.load(frames)
t1 = time.perf_counter()
load_exported_serving(art)
torch.cuda.synchronize()
t2 = time.perf_counter()
Network.run_exported_serving(art, x)
torch.cuda.synchronize()
t3 = time.perf_counter()
kfr.launches = qm.launches = 0
for _ in range(reps):
    tb, ov, probs = Network.run_exported_serving(art, x)
torch.cuda.synchronize()
counts = {"region": kfr.launches, "int8": qm.launches, "requests": reps}
np.savez(out, tb=tb.float().cpu().numpy(), ov=ov.float().cpu().numpy(),
         probs=probs.float().cpu().numpy())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "darknet_tpu"))
print(json.dumps({"counts": counts, "import_s": t1 - t0, "load_s": t2 - t1,
                  "first_request_s": t3 - t2, "foreign_modules": bad}))
"""


_started: list = []     # phase 14's processes, stopped if it fails


def _start(*args, **kw):
    proc = subprocess.Popen(*args, **kw)
    _started.append(proc)
    return proc


def export_nodes(module) -> dict:
    """Counts of a loaded artifact's op nodes (`module`: the program's
    module, `load_exported_serving`'s): the port's ops, aten's
    convolutions, and every call ("call_function")."""
    out: dict = {}
    for n in module.graph.nodes:
        t = str(n.target)
        if t.startswith(("darknet_tpu_torch.", "aten.conv")):
            out[t] = out.get(t, 0) + 1
        if n.op == "call_function":
            out[n.op] = out.get(n.op, 0) + 1
    return out


def triple_close(a, b) -> tuple:
    """(kept sets equal once each slot of a is matched to b's slot of the
    nearest box, one to one (`tests/torch_params.match_slots`' rule); the
    largest difference of each part (boxes, objectness, probs) over b's
    scale): a from the child (numpy), b eager (tensors)."""
    b = [t.float().cpu().numpy() for t in b]
    slot = np.abs(a[0][:, :, None, :] - b[0][:, None, :, :]).max(
        -1).argmin(-1)
    one_to_one = all(len(set(row)) == len(row) for row in slot)
    b = [np.take_along_axis(w, slot.reshape(slot.shape + (1,) * (
        w.ndim - 2)), 1) for w in b]
    errs = [float(np.abs(part - w).max()) / max(float(np.abs(w).max()),
                                                1e-30)
            for part, w in zip(a, b)]
    same = (set(zip(*np.nonzero(a[2] > 0)))
            == set(zip(*np.nonzero(b[2] > 0))))
    return one_to_one and same, errs


def export_one(label, net, frames, root, n_q, children):
    """Export `net`, reload it here (bitwise against eager), start the
    child that loads it.  Returns the eager triple and the numbers."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import network as netmod

    eager = net.submit_detect_device(frames)
    art = os.path.join(root, f"yolov4-608-{label}.pt2")
    t0 = time.perf_counter()
    net.export_serving(art, batch=SERVE_BATCH)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(art)
    netmod._loaded.clear()
    t0 = time.perf_counter()
    module = netmod.load_exported_serving(art)[0]
    load_s = time.perf_counter() - t0
    nodes = export_nodes(module)
    n_region = nodes.get("darknet_tpu_torch.region.default", 0)
    n_int8 = nodes.get("darknet_tpu_torch.int8_conv.default", 0)
    t0 = time.perf_counter()
    got = Network.run_exported_serving(art, frames)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    bitwise = all(torch.equal(a, b) for a, b in zip(eager, got))
    print(f"export {label}: {size} bytes, export {export_s:.2f} s, load "
          f"{load_s:.2f} s, first request {first_s:.2f} s; nodes {nodes}; "
          f"in-process reload bitwise equal to eager: {bitwise}; kept "
          f"{len(kept(eager[2]))}", flush=True)
    require(bitwise, f"{label}: the reloaded artifact serves eager's "
            f"triple bitwise")
    require((n_region, n_int8) == (1, n_q),
            f"{label}: 1 region node and {n_q} int8_conv nodes, got "
            f"{(n_region, n_int8)}")
    require(len(kept(eager[2])) > 0, f"{label}: eager keeps candidates")
    x_path = os.path.join(root, f"frames-{label}.npy")
    np.save(x_path, frames)
    out = os.path.join(root, f"child-{label}.npz")
    children[label] = (_start(
        [sys.executable, "-c", EXPORT_CHILD, art, x_path, out,
         str(EXPORT_CHILD_REQUESTS)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=child_env()), out)
    return {"eager": eager, "art": art, "bytes": size,
            "export_s": export_s, "load_s": load_s, "first_s": first_s,
            "nodes": nodes}


def child_env():
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def finish_child(label, children, res, n_q):
    proc, out = children.pop(label)
    stdout, stderr = proc.communicate(timeout=600)
    require(proc.returncode == 0,
            f"{label} child failed: {stderr[-3000:]}")
    info = json.loads(stdout.strip().splitlines()[-1])
    c = info["counts"]
    per = (c["region"] / c["requests"], c["int8"] / c["requests"])
    data = np.load(out)
    same_kept, errs = triple_close(
        [data[k] for k in ("tb", "ov", "probs")], res["eager"])
    print(f"export {label} child (imports only darknet_tpu_torch): import "
          f"{info['import_s']:.2f} s, load {info['load_s']:.2f} s, first "
          f"request {info['first_request_s']:.2f} s; launches a request: "
          f"region {per[0]}, int8 {per[1]}; kept sets equal {same_kept}, "
          f"largest differences over the scale (boxes, objectness, probs) "
          f"{errs}", flush=True)
    require(not info["foreign_modules"],
            f"{label} child imported {info['foreign_modules']}")
    require(per == (1, n_q), f"{label} child: 1 region and {n_q} int8 "
            f"launches a request, got {per}")
    require(same_kept and max(errs) <= TOL_BF16,
            f"{label} child: kept sets equal and within one bf16 ulp of "
            f"the scale")
    return {"region": c["region"], "int8": c["int8"],
            "requests": c["requests"], "load_s": info["load_s"],
            "first_s": info["first_request_s"]}


def dispatch_us():
    """Host µs of one torch.ops.darknet_tpu_torch.int8_conv.default call
    (the call `ops/quant_matmul.int8_conv` makes) and of one call of its
    CUDA backend (the binding, `int8_conv_cuda`) on a small shape (b=1,
    8x8x128 -> 128, 1x1), in turns."""
    import torch

    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)
    from darknet_tpu_torch.ops import quant_matmul as qm

    ops, kw = int8_conv_operands(1, 8, 128, 128, 1, 1, seed=0)
    x_q, w_q, ws, b, xs = ops
    xs = qm._f32(xs, x_q.device).reshape(-1)
    geo = (1, (1, 1), (0, 0), (8, 8), torch.float32, False)
    op = torch.ops.darknet_tpu_torch.int8_conv.default

    def via_op():
        return op(x_q, w_q, ws, b, xs, *geo)

    def direct():
        return qm.int8_conv_cuda(x_q, w_q, ws, b, xs, size=1, stride=(1, 1),
                                 pad_lo=(0, 0), out_hw=(8, 8))

    require(torch.equal(via_op(), direct()), "the op and the binding agree")

    def host_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / DISPATCH_CALLS * 1e6

    for fn in (via_op, direct):
        host_us(fn)
    times = [host_us(f) for f in (via_op, direct, direct, via_op)]
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2


def run_capi(root):
    """Build the C ABI twin and start native/capi/demo.c linked against it
    on the card (DTPU_DEVICE=cuda) with the fixture yolov3-tiny cfg."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "capi")
    t0 = time.perf_counter()
    r = subprocess.run(["sh", os.path.join(here, "darknet_tpu_torch", "capi",
                                           "build.sh"), out],
                       capture_output=True, text=True, timeout=300)
    require(r.returncode == 0, f"C ABI twin build: {r.stderr[-2000:]}")
    print(f"C ABI twin built with gcc in {time.perf_counter() - t0:.2f} s",
          flush=True)
    env = child_env()
    import site

    env["PYTHONPATH"] = os.pathsep.join([env["PYTHONPATH"],
                                         *site.getsitepackages()])
    env["DTPU_DEVICE"] = "cuda"
    env["DTPU_DEMO_WEIGHTS"] = os.path.join(root, "dtpu_demo.weights")
    return _start(
        [r.stdout.strip().splitlines()[-1],
         os.path.join(here, "tests", "fixtures", "yolov3-tiny.cfg"), "",
         "0.05"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=root)


WALKTHROUGH_ITERS = 3      # walkthrough 01's iterations (its test runs 12)


def run_walkthroughs(root):
    """The walkthrough twins 01-05 on the card at their test sizes, in one
    workdir: 01, then 02-05 together (05 on a mesh naming the card twice:
    two gloo ranks).  Returns their outputs."""
    here = os.path.dirname(os.path.abspath(__file__))
    ex = os.path.join(here, "darknet_tpu_torch", "examples")
    work = os.path.join(root, "shapes_demo")

    def start(name, *args):
        return _start(
            [sys.executable, os.path.join(ex, name), "--workdir", work,
             "--device", "cuda", *args], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=child_env(), cwd=root)

    def done(name, proc):
        out, err = proc.communicate(timeout=600)
        require(proc.returncode == 0, f"{name}: {err[-2000:]}")
        return out

    t0 = time.perf_counter()
    outs = {"01": done("01", start("01_train_synthetic.py", "--iters",
                                   str(WALKTHROUGH_ITERS), "--images",
                                   "48"))}
    procs = {"02": start("02_detect.py", "--thresh", "0.01"),
             "03": start("03_serving_export.py", "--batch", "4"),
             "04": start("04_video_tracking.py"),
             "05": start("05_multichip.py", "--thresh", "0.01")}
    outs.update({k: done(k, p) for k, p in procs.items()})
    marks = {"01": ("final EMA loss:", "mAP@0.5"), "02": ("JSON:",),
             "03": ("img/s", "torch.export artifact"),
             "04": ("output video:",),
             "05": ("the same boxes as one device", "weights digest")}
    files = {"01": "backup/shapes_final.weights", "02": "detections.png",
             "03": "shapes_serving.pt2", "04": "tracking.y4m",
             "05": "backup/shapes_final.weights"}
    for k, out in outs.items():
        require(all(m in out for m in marks[k])
                and os.path.exists(os.path.join(work, files[k])),
                f"walkthrough {k}: {out[-1500:]}")
    digests = {ln.split("weights digest ")[1]
               for ln in outs["05"].splitlines() if "weights digest" in ln}
    require(len(digests) == 1, f"walkthrough 05: the ranks' weights differ: "
            f"{outs['05'][-1500:]}")
    lines = [ln for k in ("01", "03", "04", "05")
             for ln in outs[k].splitlines()
             if "mAP@0.5" in ln or "img/s" in ln or "fps" in ln
             or "mesh serving" in ln]
    print(f"walkthrough twins 01-05 on the card in "
          f"{time.perf_counter() - t0:.2f} s: " + " | ".join(lines),
          flush=True)


def phase_export(card):
    """Phase 14 (`--only export`): the serving artifact of yolov4-608 at
    b=8, bf16 and calibrated int8; its rates against eager; the op
    dispatch's cost; the C ABI twin; the walkthrough twins."""
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as root:
            out = export_phase(card, root)
    finally:
        for proc in _started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        _started.clear()
    print(f"phase 14 (export) in {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)
    return out


def export_phase(card, root):
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.weights import io as wio

    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    rng = np.random.default_rng(14)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = rng.uniform(0, 1, shape).astype(np.float32)

    # probe weights: the objectness threshold .25 sits in a gap of the
    # bf16 heads' logits on these frames (PROBE_PASS candidates an image
    # and head), so that the kept set does not rest on ties
    t0 = time.perf_counter()
    g = quiet_graph(cfg_text)
    probe = Network(g, paramlib.params_to_torch(
        g, probe_params(g), DEVICE, torch.bfloat16),
        compute_dtype=torch.bfloat16, device=DEVICE)
    with torch.inference_mode():
        raw = probe._fwd(probe.params,
                         torch.from_numpy(frames).to(DEVICE))["raw_heads"]
    bias = obj_bias_for([h.float() for h in raw], 0.25,
                        PROBE_PASS * SERVE_BATCH)
    del probe, raw
    weights = os.path.join(root, "probe.weights")
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)

    def net(int8):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Network.from_cfg(cfg, weights=weights, int8=int8,
                                    compute_dtype=torch.bfloat16,
                                    device=DEVICE)

    bf16, q = net(False), net(True)
    q.calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(np.float32)
                      for _ in range(INT8_CALIB_FRAMES)])
    n_q = sum("x_scale" in p for p in q.params)
    require(n_q == INT8_CONVS, f"{INT8_CONVS} calibrated convs, got {n_q}")
    print(f"export setup (probe weights, two networks, calibration): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # (d), (e): the C ABI twin and the walkthrough twins start first and
    # run beside (a) and (b) (their own processes; the exports are host
    # work on one core), and end before (c)'s rates, which want a quiet
    # host
    t_de = time.perf_counter()
    demo = run_capi(root)
    walk: dict = {}

    def walkthroughs():
        try:
            run_walkthroughs(root)
        except BaseException as e:  # re-raised in the phase's thread
            walk["error"] = e
        walk["s"] = time.perf_counter() - t_de

    walker = threading.Thread(target=walkthroughs)
    walker.start()

    # (a), (b): export, save, reload here; each child starts at once and
    # runs beside what follows up to the rates
    t0 = time.perf_counter()
    children: dict = {}
    res = {"bf16": export_one("bf16", bf16, frames, root, 0, children),
           "int8": export_one("int8", q, frames, root, INT8_CONVS,
                              children)}
    for label, n in (("bf16", 0), ("int8", INT8_CONVS)):
        res[label]["child"] = finish_child(label, children, res[label], n)
    print(f"export (a), (b) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    walker.join()
    if "error" in walk:
        raise walk["error"]
    stdout, stderr = demo.communicate(timeout=600)
    require(demo.returncode == 0, f"C demo failed: {stderr[-2000:]}")
    n = int([ln for ln in stdout.splitlines()
             if ln.startswith("detections:")][0].split()[1])
    for want in ("net 416x416x3 classes=80", "json head:", "weights saved",
                 "ok"):
        require(want in stdout, f"C demo prints {want!r}: {stdout[-800:]}")
    require(n > 0, "the C demo detects")
    # the unchanged client saves to a fixed /tmp path, which the twin's
    # build sends to DTPU_DEMO_WEIGHTS (`run_capi`)
    saved = os.path.join(root, "dtpu_demo.weights")
    require(os.path.getsize(saved) > 0, "the C demo saved weights")
    print("C demo (native/capi/demo.c against libdarknet_tpu_torch_c.so, "
          "DTPU_DEVICE=cuda): " + " | ".join(
              ln for ln in stdout.splitlines()
              if ln.startswith(("net ", "detections:", "tracks:", "ok"))),
          flush=True)
    print(f"export (d), (e) beside (a), (b) in {walk['s']:.1f} s",
          flush=True)
    t0 = time.perf_counter()

    # (c) the artifact's rate against eager's, interleaved, same frames
    from darknet_tpu_torch.nn import network as netmod

    rates = {}
    for label, n in (("bf16", bf16), ("int8", q)):
        art = res[label]["art"]

        def artifact():
            Network.device_out_to_dets(
                *Network.run_exported_serving(art, frames))

        netmod.load_exported_serving(art)
        got = {"eager": [], "artifact": []}
        for i in range(EXPORT_ROUNDS):
            for way in ("eager", "artifact")[::1 if i % 2 == 0 else -1]:
                got[way] += serve_rate(
                    n, frames, request=artifact if way == "artifact"
                    else None, **EXPORT_RATE)[2]
        rates[label] = {}
        for way, rs in got.items():
            med = float(np.median(rs))
            rates[label][way] = (med, (max(rs) - min(rs)) / med)
        print(f"export {label} rates ({card}): eager "
              f"{rates[label]['eager'][0]:.2f} img/s (spread "
              f"{rates[label]['eager'][1]:.3f}), artifact "
              f"{rates[label]['artifact'][0]:.2f} img/s (spread "
              f"{rates[label]['artifact'][1]:.3f}), {EXPORT_ROUNDS} "
              f"windows of {EXPORT_RATE['requests']} requests each way, in "
              f"turns", flush=True)
        # one request each way in a trace: device events, busy, idle
        trace_summary(lambda: n.device_out_to_dets(
            *n.submit_detect_device(frames)), f"export {label} eager",
            card, 4)
        trace_summary(artifact, f"export {label} artifact", card, 4)
    op_us, direct_us = dispatch_us()
    print(f"int8_conv dispatch ({card}): torch.ops call {op_us:.1f} us, "
          f"the binding {direct_us:.1f} us, host time a call "
          f"(b=1 8x8x128 -> 128 1x1, {DISPATCH_CALLS} calls)", flush=True)
    del bf16, q
    torch.cuda.empty_cache()
    print(f"export (c) in {time.perf_counter() - t0:.1f} s", flush=True)

    return {label: {"child": res[label]["child"], "rates": rates[label],
                    "bytes": res[label]["bytes"]}
            for label in ("bf16", "int8")}


# data parallelism (phase 15): yolov4-608 trained over two gloo ranks that
# share the one card (global batch 8, subdivisions 2: micro-batches of 4,
# 2 a rank) and served on a mesh that names the card twice
PAR_DEVICES = ("cuda:0", "cuda:0")
PAR_BATCH = 8
PAR_ACCUM = 2
PAR_SEED = 15
PAR_TIMED_STEPS = 2
PAR_RATE = dict(warmup=2, windows=1, requests=10)
PAR_ROUNDS = 2            # windows each way, unsharded and mesh in turns
PAR_VALID_IMAGES = 8


def par_train_cfg(tiny: bool = False) -> str:
    """yolov4-608 (yolov4-tiny-608 with `tiny`) at the global batch and
    subdivisions of phase 15, burn_in 0 (so that the first step moves
    the weights)."""
    from darknet_tpu_torch import model_zoo

    text = (model_zoo.yolov4_tiny_cfg if tiny else model_zoo.yolov4_cfg)(
        SERVE_PX, SERVE_PX)
    lines = []
    for ln in text.splitlines():
        key = ln.split("=")[0].strip()
        if key == "batch":
            ln = f"batch={PAR_BATCH}"
        elif key == "subdivisions":
            ln = f"subdivisions={PAR_ACCUM}"
        elif key == "burn_in":
            ln = "burn_in=0"
        lines.append(ln)
    return "\n".join(lines) + "\n"


class deterministic:
    """cuDNN's deterministic algorithms and torch's deterministic
    scatters inside the block, restored after it."""

    def __enter__(self):
        import torch

        self.prev = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.deterministic = self.prev[0]
        torch.use_deterministic_algorithms(self.prev[1])


def par_stepper(graph, mesh=None):
    """One f32 step (TF32 off) on the card from a numpy state (params,
    momentum, counter), through make_dp_train_step where `mesh` is given,
    on the rows it is handed: (state after, cost)."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel import make_dp_train_step
    from darknet_tpu_torch.train.step import make_train_step

    step = make_train_step(graph, accum=PAR_ACCUM) if mesh is None else \
        make_dp_train_step(graph, mesh, accum=PAR_ACCUM)

    def run(state, x, y):
        params, u, t = state
        p = paramlib.train_params_to_torch(graph, params, DEVICE)
        o = {"t": t, "u": paramlib.numpy_to_train_layout(graph, u, DEVICE)}
        p, o, c, _m = step(p, o, torch.from_numpy(x).to(DEVICE),
                           torch.from_numpy(y).to(DEVICE), graph.net.lr)
        return ((paramlib.train_params_to_numpy(graph, p),
                 paramlib.train_params_to_numpy(graph, o["u"]), o["t"]),
                float(c))
    return run, step


def par_step_ms(graph, step, p, o, xt, yt, profile_it=False):
    """Host ms of each of PAR_TIMED_STEPS steps (synchronised) on the
    state (p, o) on the card, after steps of these shapes have run (no
    warm-up here); with profile_it, also (the step's wall ms, the ms with
    an all-reduce in flight, the all-reduces' count, their spans by name)
    from a trace of one more step."""
    import torch

    ms = []
    for _ in range(PAR_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, c, _m = step(p, o, xt, yt, graph.net.lr)
        float(c)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not profile_it:
        return ms, None
    from torch.profiler import ProfilerActivity, profile

    # host activity only: the spans read below are host spans, and the
    # device's kernel events (tens of thousands a step) would only slow
    # the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        p, o, c, _m = step(p, o, xt, yt, graph.net.lr)
        float(c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the all-reduces' host spans (the c10d op on the step's thread, gloo's
    # on its own threads), read from the trace's raw events (building the
    # event tree of a step's host ops takes longer than the step): the
    # step's time with one in flight is the union of their intervals
    names: dict = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "allreduce" in name.replace("_", "").lower():
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            n, us = names.get(name, (0, 0.0))
            names[name] = (n + 1, us + dur)
            spans.append((start, start + dur))
    coll, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            coll, reach = coll + end - start, end
        elif end > reach:
            coll, reach = coll + end - reach, end
    n_ops = sum(n for k, (n, _us) in names.items() if k.startswith("c10d::"))
    return ms, (wall, coll / 1e3, n_ops,
                {k: [n, round(us / 1e3, 1)] for k, (n, us) in names.items()})


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for tree in state[:2]:
        for d in tree:
            for k in sorted(d):
                h.update(k.encode())
                h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def parallel_rank(rank, root, cfg_text):
    """One of phase 15's two gloo ranks on the card: the data-parallel
    step from the seed's state on this rank's block of the global batch
    (rank 0 writes the state after it), then the timed and the profiled
    steps; each rank writes its digest, cost and times, and the seconds
    of each stage of its run (`stages`)."""
    t_in = time.perf_counter()
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.parallel.multihost import process_batch_slice
    from darknet_tpu_torch.train.step import init_opt_state

    mesh = make_mesh(devices=list(PAR_DEVICES))
    g = quiet_graph(cfg_text, train=True)
    x, y = train_batch(g, PAR_BATCH, PAR_SEED)
    s, n = process_batch_slice(PAR_BATCH)
    step = par_stepper(g, mesh)[1]
    # the seed's state on the card: params, zero momentum, counter 0
    p = paramlib.train_params_to_torch(g, paramlib.init_params(g, seed=0),
                                       DEVICE)
    o = init_opt_state(g, p)
    xt = torch.from_numpy(x[s:s + n]).to(DEVICE)
    yt = torch.from_numpy(y[s:s + n]).to(DEVICE)
    t0 = time.perf_counter()
    stages = {"set-up": t0 - t_in}
    p, o, c, _m = step(p, o, xt, yt, g.net.lr)
    cost = float(c)
    first_s = stages["first step"] = time.perf_counter() - t0
    state = (paramlib.train_params_to_numpy(g, p),
             paramlib.train_params_to_numpy(g, o["u"]), o["t"])
    if rank == 0:
        np.savez(os.path.join(root, "dp_state.npz"), **{
            f"{w}/{i}/{k}": v for w, tree in (("p", state[0]),
                                              ("u", state[1]))
            for i, d in enumerate(tree) for k, v in d.items()})
    t0 = time.perf_counter()
    stages["state out"] = t0 - t_in - sum(stages.values())
    # every rank steps under the profiler: the step's collectives need
    # both ranks
    ms, prof = par_step_ms(g, step, p, o, xt, yt, profile_it=True)
    stages["timed steps"] = sum(ms) / 1e3
    stages["profiled step and its events"] = \
        time.perf_counter() - t0 - stages["timed steps"]
    with open(os.path.join(root, f"dp_rank{rank}.json"), "w") as f:
        json.dump({"digest": state_digest(state), "cost": cost,
                   "t": state[2], "first_s": first_s, "ms": ms,
                   "profile": prof,
                   "stages": {k: round(v, 2) for k, v in stages.items()}},
                  f)


def phase_parallel(card):
    """Phase 15 (`--only parallel`): data parallelism at full width."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        out = {"train": parallel_train(card, root)}
        out.update(parallel_serve(card, root))
        out["valid"] = parallel_valid(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 15 (data parallelism) in "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return out


def parallel_train(card, root):
    """Phase 15 (a): yolov4-608, global batch 8, subdivisions 2, f32 with
    TF32 off, the seed's init: the single-process step; an NCCL world of
    one, bitwise that step (deterministic algorithms); then two gloo ranks
    on the card, each on its block, held to the single-process step in
    phase 8 (a)'s form for a chaotic graph (ten yardsticks of the card's
    own response to a 1e-7 input change, capped at 30% of the update),
    the ranks bitwise equal; the times of both, the all-reduces' share of
    a profiled rank step."""
    import torch
    import torch.distributed as dist

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.parallel.multihost import free_port, spawn
    from darknet_tpu_torch.train.step import init_opt_state

    cfg_text = par_train_cfg()
    g = quiet_graph(cfg_text, train=True)
    p0 = paramlib.init_params(g, seed=0)
    x, y = train_batch(g, PAR_BATCH, PAR_SEED)
    noise = np.random.default_rng(99).standard_normal(x.shape)
    x_eps = (x * (1 + 1e-7 * noise)).astype(np.float32)
    state0 = train_state0(g, p0)
    run, step = par_stepper(g)
    t0 = time.perf_counter()
    with deterministic():
        ref, c_ref = run(state0, x, y)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            mesh1 = make_mesh(devices=[DEVICE])
            one, c_one = par_stepper(g, mesh1)[0](state0, x, y)
        finally:
            dist.destroy_process_group()
    same = state_digest(one) == state_digest(ref) and c_one == c_ref
    print(f"(a) yolov4-{SERVE_PX} batch {PAR_BATCH} subdivisions "
          f"{PAR_ACCUM} f32: an NCCL world of one bitwise the step without "
          f"a mesh: {same} (costs {c_one}, {c_ref})", flush=True)
    require(same, "an NCCL world of one is the step without a mesh")
    eps, _ = run(state0, x_eps, y)
    p = paramlib.train_params_to_torch(g, p0, DEVICE)
    single_ms, _ = par_step_ms(g, step, p, init_opt_state(g, p),
                               torch.from_numpy(x).to(DEVICE),
                               torch.from_numpy(y).to(DEVICE))
    del p
    print(f"single-process steps: {time.perf_counter() - t0:.1f} s", flush=True)
    del step, run
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spawn(parallel_rank, PAR_DEVICES, root, cfg_text, timeout_s=900)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(len(PAR_DEVICES)):
        with open(os.path.join(root, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    z = np.load(os.path.join(root, "dp_state.npz"))
    dp = ([{k: z[f"p/{i}/{k}"] for k in d} for i, d in enumerate(p0)],
          [{k: z[f"u/{i}/{k}"] for k in d} for i, d in enumerate(state0[1])])
    require(len({r["digest"] for r in ranks}) == 1 and
            len({r["cost"] for r in ranks}) == 1,
            "the two ranks end the step bitwise equal")
    line = []
    for what, i, keys in (("updates", 0, ("w", "b", "scales")),
                          ("stats", 0, ("mean", "var")),
                          ("momentum", 1, ("w", "b", "scales"))):
        err, scale = update_gap(dp[i], ref[i], state0[i], keys)
        yard, _ = update_gap(ref[i], eps[i], state0[i], keys)
        line.append(f"{what} err {err:.3g} of {scale:.3g} (1e-7 input "
                    f"change: {yard:.3g})")
        require(scale > 0 and err <= min(YARDSTICK_V4 * yard + 1e-4 * scale,
                                         CAP * scale),
                f"the data-parallel step's {what} agree with one process's")
    dp_ms = [max(a, b) for a, b in zip(ranks[0]["ms"], ranks[1]["ms"])]
    wall, coll, n_coll, names = ranks[0]["profile"]

    def spread(ms):
        return (f"{', '.join(f'{m:.1f}' for m in ms)}: median "
                f"{np.median(ms):.1f}, spread "
                f"{(max(ms) - min(ms)) / np.median(ms):.1%}")
    print(f"(a) two gloo ranks on {PAR_DEVICES} (blocks of "
          f"{PAR_BATCH // 2}), held to one process: cost {ranks[0]['cost']:.6g}"
          f" against {c_ref:.6g}; " + "; ".join(line) + "; the ranks bitwise "
          f"equal: True", flush=True)
    print(f"(a) step ms at global batch {PAR_BATCH} ({card}), "
          f"{PAR_TIMED_STEPS} steps each: one process {spread(single_ms)}; "
          f"two ranks {spread(dp_ms)} "
          f"({np.median(dp_ms) / np.median(single_ms):.2f}x the medians); "
          f"a profiled rank step {wall:.1f} ms, of which {n_coll} "
          f"all-reduces in flight {coll:.1f} ms ({coll / wall:.1%}; the "
          f"spans' count and ms by name {names}); the spawned world "
          f"{spawn_s:.1f} s, rank 0's stages in s {ranks[0]['stages']}",
          flush=True)
    return {"single_ms": single_ms, "dp_ms": dp_ms, "coll_share": coll / wall}


class int8_records:
    """Inside the block, every int8_conv (its operands and output)
    recorded, for `bitwise_to_plain` after the block."""

    def __enter__(self):
        from darknet_tpu_torch.ops import conv as convmod

        self.records, self.orig = [], convmod.int8_conv
        orig = self.orig

        def recorded(x_q, w_q, ws, bias, xs, **kw):
            y = orig(x_q, w_q, ws, bias, xs, **kw)
            self.records.append(((x_q, w_q, ws, bias, xs), kw, y))
            return y

        convmod.int8_conv = recorded
        return self

    def __exit__(self, *exc):
        from darknet_tpu_torch.ops import conv as convmod

        convmod.int8_conv = self.orig

    def bitwise_to_plain(self):
        """(The recorded launches bitwise equal to the plain version on
        their operands (no kernel launch), their count); the records go."""
        import torch

        from darknet_tpu_torch.ops import quant_matmul as qm

        n_eq = sum(bool(torch.equal(y, qm.int8_conv_plain(*ops, **kw)))
                   for ops, kw, y in self.records)
        n, self.records = len(self.records), []
        return n_eq, n


def score_noise(a_pre, b_pre):
    """Two requests' pre-NMS triples (nms=0) with b's slots matched to
    a's by box: (the slot match, a's candidates that b holds too, the
    largest score difference over entries both pass, the largest box
    difference over the candidates both hold)."""
    ta = a_pre[0].float().cpu().numpy()
    tb = b_pre[0].float().cpu().numpy()
    d = np.abs(ta[:, :, None, :] - tb[:, None, :, :]).max(-1)
    slot = d.argmin(-1)
    pa = a_pre[2].float().cpu().numpy()
    pb = np.take_along_axis(b_pre[2].float().cpu().numpy(),
                            slot[..., None], 1)
    # a candidate of a that b holds: b's nearest box is live and near
    live_b = np.take_along_axis(b_pre[1].float().cpu().numpy() > 0, slot, 1)
    held = live_b & (a_pre[1].float().cpu().numpy() > 0) \
        & (np.take_along_axis(d, slot[..., None], 2)[..., 0] <= 1.0)
    both = (pa > 0) & (pb > 0) & held[..., None]
    tol_p = float(np.abs(pa - pb)[both].max()) if both.any() else 0.0
    box = np.take_along_axis(tb, slot[..., None], 1)
    tol_box = float(np.abs(ta - box)[held].max()) if held.any() else 0.0
    return slot, held, tol_p, tol_box


def flips_explained(a, a_pre, b, b_pre, thresh, nms, kind, beta):
    """The kept entries (image, slot, class) of request a that request b
    does not keep the same way, slots matched by box, each traced to a
    decision that the two requests' pre-NMS triples (`a_pre`, `b_pre`,
    nms=0) took the other way: the threshold (one score passes, and by
    no more than the score noise), an NMS overlap with a same-class
    rival (over `nms` in one, not in the other), the score order with an
    overlapping rival, or a chain (an overlapping rival is itself a
    traced difference).  Returns (the differing entries, their reasons,
    the unexplained, the score noise)."""
    from darknet_tpu_torch.ops import nms as nmslib

    slot, held, tol_p, _tol_box = score_noise(a_pre, b_pre)
    pa = a_pre[2].float().cpu().numpy()
    pb = np.take_along_axis(b_pre[2].float().cpu().numpy(),
                            slot[..., None], 1) * held[..., None]
    ka = a[2].float().cpu().numpy() > 0
    kb = (np.take_along_axis(b[2].float().cpu().numpy(), slot[..., None], 1)
          > 0) & held[..., None]
    ta = a_pre[0].float().cpu().numpy()
    tb = np.take_along_axis(b_pre[0].float().cpu().numpy(), slot[..., None],
                            1)

    def sim(t):
        if kind == "greedynms":
            return nmslib._np_iou(t[:, None], t[None])
        return nmslib._np_diou(t[:, None], t[None], beta)

    diff = set(zip(*np.nonzero(ka != kb)))
    sims = {i: (sim(ta[i]) > nms, sim(tb[i]) > nms)
            for i in {e[0] for e in diff}}
    reasons = {}
    grew = True
    while grew:
        grew = False
        for e in sorted(diff - reasons.keys()):
            i, k, c = e
            passed = [v for v in (pa[e], pb[e]) if v > 0]
            why = None
            if len(passed) == 1 and passed[0] <= thresh + tol_p:
                why = "threshold"
            over_a, over_b = sims[i]
            for f in np.nonzero((pa[i, :, c] > 0) | (pb[i, :, c] > 0))[0]:
                if why is not None:
                    break
                if f == k or not (over_a[k, f] or over_b[k, f]):
                    continue
                if over_a[k, f] != over_b[k, f]:
                    why = "overlap"
                elif (pa[i, k, c] > pa[i, f, c]) != (pb[i, k, c]
                                                     > pb[i, f, c]):
                    why = "order"
                elif (i, f, c) in reasons:
                    why = "chain"
            if why is not None:
                reasons[e] = why
                grew = True
    return diff, reasons, sorted(diff - reasons.keys()), tol_p


def parallel_serve(card, root):
    """Phase 15 (b): yolov4-608 b=8, bf16, calibrated int8 and f32, served
    on a mesh naming the card twice: the region kernel at the blocks'
    shape against its plain version (phase 1's check), the launches of a
    request (each kernel once a block), each int8 launch bitwise its
    plain version, the triple bitwise that of each block served alone,
    an f32 block of 4 against the plain regions, the kept detections the
    unsharded
    request's once slots are matched by box (bf16: each difference
    traced to a decision within the noise, `flips_explained`), and the
    mesh's img/s against the unsharded (bf16, int8)."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.weights import io as wio

    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    rng = np.random.default_rng(PAR_SEED)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = rng.uniform(0, 1, shape).astype(np.float32)
    g = quiet_graph(cfg_text)
    probe = Network(g, paramlib.params_to_torch(
        g, probe_params(g), DEVICE, torch.bfloat16),
        compute_dtype=torch.bfloat16, device=DEVICE)
    with torch.inference_mode():
        raw = probe._fwd(probe.params,
                         torch.from_numpy(frames).to(DEVICE))["raw_heads"]
    bias = obj_bias_for([h.float() for h in raw], 0.25,
                        PROBE_PASS * SERVE_BATCH)
    del probe, raw
    weights = os.path.join(root, "probe.weights")
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)
    nets = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label in ("bf16", "int8"):
            nets[label] = Network.from_cfg(cfg, weights=weights,
                                           int8=label == "int8",
                                           compute_dtype=torch.bfloat16,
                                           device=DEVICE)
        nets["f32"] = Network.from_cfg(cfg, weights=weights, device=DEVICE)
    # the f32 network's params through the plain regions
    plain = Network(nets["f32"].graph, nets["f32"].params,
                    fused=nets["f32"].fused, device=DEVICE,
                    fuse_regions="plain")
    nets["int8"].calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(
        np.float32) for _ in range(INT8_CALIB_FRAMES)])
    mesh = make_mesh(devices=list(PAR_DEVICES))
    n = len(PAR_DEVICES)
    per = SERVE_BATCH // n
    # the region kernel against its plain version at the mesh's block
    # shape, as phase 1 holds it at b=2 and b=8
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        checks = [check_region(f"yolov4-{SERVE_PX}-prefix", g, per, dt,
                               seed=SERVE_PX)
                  for dt in (torch.float32, torch.bfloat16)]
    require(all(c["ok"] for c in checks), f"the region kernel at blocks "
            f"of {per} agrees with its plain version")
    out = {}
    with torch.inference_mode():
        pre = {"f32": nets["f32"].submit_detect_device(frames, nms=0)}
    for label, net in nets.items():
        with torch.inference_mode():
            whole = net.submit_detect_device(frames)
            blocks = [net.submit_detect_device(frames[i * per:(i + 1) * per])
                      for i in range(n)]
            torch.cuda.synchronize()
            with int8_records() as rec:
                kfr.launches = qm.launches = 0
                got = net.submit_detect_device(frames, mesh=mesh)
                torch.cuda.synchronize()
                launches = (kfr.launches, qm.launches)
            if label == "bf16":
                pre["bf16"] = net.submit_detect_device(frames, nms=0)
                pre["mesh"] = net.submit_detect_device(frames, nms=0,
                                                       mesh=mesh)
        want = (n, n * INT8_CONVS if label == "int8" else 0)
        require(launches == want, f"mesh {label}: {want} (region, int8) "
                f"launches a request, got {launches}")
        if label == "int8":
            with torch.inference_mode():
                q_eq, q_n = rec.bitwise_to_plain()
            print(f"(b) mesh int8: {q_eq} of the request's {q_n} int8 "
                  f"launches (blocks of {per}) bitwise equal to the plain "
                  f"version on their operands", flush=True)
            require(q_eq == q_n == launches[1], "mesh int8: every int8 "
                    "launch of the request bitwise its plain version")
        same = all(torch.equal(a, torch.cat(parts))
                   for a, parts in zip(got, zip(*blocks)))
        require(same, f"mesh {label}: the triple is each block's served alone")
        ka, kb, box_err = kept_matched(got, whole)
        diff = sorted(ka ^ kb)
        sa = got[2].float().cpu().numpy()
        print(f"(b) mesh {label}: kept {len(ka)} against the unsharded "
              f"{len(kb)}, {len(diff)} differ: " + ", ".join(
                  f"{tuple(map(int, d))} p={float(sa[d]):.5g} "
                  f"obj={float(got[1][d[:2]]):.5g}"
                  for d in diff[:12]), flush=True)
        if label == "bf16":
            # bf16 rounds a conv's sum once, and cuDNN picks the algorithm
            # by batch size: a decision near the threshold or NMS's
            # overlap may go the other way in a block of 4 than in the
            # batch of 8 (the blocks served alone without a mesh do the
            # same: the triple above is theirs bitwise); both ways, every
            # such difference is traced to the decision that flipped, and
            # the score noise is held under bf16's own against f32
            args = (0.25, 0.45, net._nms_kind, net._nms_beta)
            fwd = flips_explained(got, pre["mesh"], whole, pre["bf16"], *args)
            bwd = flips_explained(whole, pre["bf16"], got, pre["mesh"], *args)
            yard_p = score_noise(pre["bf16"], pre["f32"])[2]
            _s, _h, noise_p, noise_box = score_noise(pre["mesh"], pre["bf16"])
            why = {}
            for r in (fwd[1], bwd[1]):
                for v in r.values():
                    why[v] = why.get(v, 0) + 1
            print(f"(b) mesh bf16: differences traced (both ways) {why}, "
                  f"unexplained {fwd[2] + bwd[2]}; pre-NMS score noise "
                  f"{noise_p:.4g} (bf16 against f32 at the batch of 8: "
                  f"{yard_p:.4g}), boxes {noise_box:.4g} px", flush=True)
            require(not fwd[2] and not bwd[2] and noise_p <= yard_p,
                    "mesh bf16: every kept difference traced to a decision "
                    "that flipped, the score noise under bf16's own")
        else:
            require(len(ka) > 0 and ka == kb, f"mesh {label}: the kept "
                    f"detections are the unsharded request's "
                    f"({len(diff)} differ)")
        dets = Network.device_out_to_dets(*got)
        out[label] = {"launches": launches}
        if label == "f32":
            # the mesh's block of 4 through the kernel against the plain
            # regions, slots matched by box
            with torch.inference_mode():
                pb4 = plain.submit_detect_device(frames[:per])
            k4, p4, err4 = kept_matched(blocks[0], pb4)
            print(f"(b) mesh f32 ({card}): {launches[0]} region launches a "
                  f"request; the triple bitwise each block's alone: {same}; "
                  f"kept {len(ka)} = the unsharded request's (boxes within "
                  f"{box_err:.3g}); a block of {per} through the kernel "
                  f"keeps {len(k4)}, the plain regions {len(p4)} (boxes "
                  f"within {err4:.3g})", flush=True)
            require(len(k4) > 0 and k4 == p4, f"f32: a block of {per} keeps "
                    f"the plain regions' set")
            continue
        rates = {"unsharded": [], "mesh": []}
        for i in range(PAR_ROUNDS):
            for way in ("unsharded", "mesh")[::1 if i % 2 == 0 else -1]:
                req = None if way == "unsharded" else (
                    lambda net=net: net.device_out_to_dets(
                        *net.submit_detect_device(frames, mesh=mesh)))
                rates[way] += serve_rate(net, frames, request=req,
                                         **PAR_RATE)[2]
        med = {w: float(np.median(r)) for w, r in rates.items()}
        spread = {w: (max(r) - min(r)) / med[w] for w, r in rates.items()}
        print(f"(b) mesh {label} ({card}): {launches[0]} region and "
              f"{launches[1]} int8 launches a request over {PAR_DEVICES}; "
              f"the triple bitwise each block's alone: {same}; kept "
              f"{len(ka)} (the unsharded {len(kb)}; boxes within "
              f"{box_err:.3g}), {sum(map(len, dets))} detections; img/s "
              f"mesh {med['mesh']:.2f} against unsharded "
              f"{med['unsharded']:.2f}, the medians of "
              f"{PAR_ROUNDS * PAR_RATE['windows']} windows of "
              f"{PAR_RATE['requests']} each way in turns (mesh "
              f"{[round(r, 2) for r in rates['mesh']]}, spread "
              f"{spread['mesh']:.1%}; unsharded "
              f"{[round(r, 2) for r in rates['unsharded']]}, spread "
              f"{spread['unsharded']:.1%})", flush=True)
        out[label]["img_s"] = med
    del nets, plain, pre
    torch.cuda.empty_cache()
    return out


def parallel_valid(card, root):
    """Phase 15 (c): `-mode valid -num_chips 2` through the CLI's main over
    PAR_VALID_IMAGES synth images, yolov4-608 f32 on probe weights (phase
    9's threshold gap), the mesh's devices named PAR_DEVICES (the CLI's
    own, cuda:0..N-1, need N cards): two region launches a batch of 8,
    the MapResult of the one-device run."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.apps import cli
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.data.image import (load_image_rgb,
                                              resize_image_darknet)
    from darknet_tpu_torch.eval import map as maplib
    from darknet_tpu_torch.ops.cuda import fused_region as kfr
    from darknet_tpu_torch.weights import io as wio

    files = synth.generate(os.path.join(root, "vdata"), n_train=0,
                           n_val=PAR_VALID_IMAGES, seed=PAR_SEED)
    names = os.path.join(root, "all.names")
    with open(names, "w") as f:
        f.write("\n".join(synth.NAMES + [f"c{i}" for i in range(
            len(synth.NAMES), VALID_CLASSES)]) + "\n")
    data = os.path.join(root, "obj.data")
    with open(data, "w") as f:
        f.write(f"classes = {VALID_CLASSES}\ntrain = {files['val_list']}\n"
                f"valid = {files['val_list']}\nnames = {names}\n"
                f"save = {os.path.join(root, 'backup')}\n")
    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4v.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    weights = os.path.join(root, "valid.weights")
    wio.save_weights(g, unfolded(g, probe_params(g)), weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=weights, device=DEVICE,
                               fuse_regions="plain")
    raw = []
    with torch.inference_mode():
        for s in range(0, PAR_VALID_IMAGES, VALID_BATCH):
            x = np.stack([resize_image_darknet(load_image_rgb(p), SERVE_PX,
                                               SERVE_PX)
                          for p in files["val_paths"][s:s + VALID_BATCH]])
            raw.append(net._fwd(net.params, torch.from_numpy(x).to(
                DEVICE))["raw_heads"])
    raw = [torch.cat(h) for h in zip(*raw)]
    bias = obj_bias_for(raw, VALID_THRESH, VALID_PASS * PAR_VALID_IMAGES)
    del net, raw
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)

    runs = []
    validate_detector = maplib.validate_detector

    def spy_validate(net, *a, **kw):
        kfr.launches = 0
        res = validate_detector(net, *a, **kw)
        runs.append((res, kfr.launches, kw.get("mesh")))
        return res

    argv = ["-mode", "valid", "-data_file", data, "-model_file", cfg,
            "-weights_file", weights, "-device", DEVICE]
    mesh_devices = cli._mesh_devices
    maplib.validate_detector = spy_validate
    cli._mesh_devices = lambda args: list(PAR_DEVICES)
    try:
        cli.main(argv)
        cli.main(argv + ["-num_chips", str(len(PAR_DEVICES))])
    finally:
        maplib.validate_detector = validate_detector
        cli._mesh_devices = mesh_devices
    (one, n_one, m_one), (two, n_two, m_two) = runs
    batches = PAR_VALID_IMAGES // VALID_BATCH
    require(m_one is None and m_two is not None, "the second run rode a mesh")
    require(n_one == batches and n_two == len(PAR_DEVICES) * batches,
            f"region launches: {n_one} one device, {n_two} on the mesh")
    same = (one.map == two.map and one.n_pred == two.n_pred and
            one.n_gt == two.n_gt and
            np.array_equal(one.per_class_ap, two.per_class_ap))
    print(f"(c) -mode valid -num_chips {len(PAR_DEVICES)} ({card}): mAP@0.5 "
          f"{two.map:.6g}, {two.n_pred} predictions, {two.n_gt} GT, the "
          f"one-device MapResult: {same}; region launches {n_two} ({n_one} "
          f"on one device); prediction {two.imgs_per_s:.2f} img/s against "
          f"{one.imgs_per_s:.2f}", flush=True)
    require(same, "-mode valid on the mesh gives the one-device MapResult")
    return {"region": n_two}


# phase 16: model parallelism (serving)
MP_SEED = 16
MP_DEVICE = "cuda:0"
MP_SPATIAL = ((1, 2), (2, 2))            # (dp, sp) meshes naming the card
MP_TENSOR = ((1, 2), (2, 2))             # (dp, tp)
MP_PIPELINE = ((2, 2), (2, 4), (4, 2), (4, 4))   # (stages, micro-batches)
MP_RATE = dict(warmup=2, windows=1, requests=10)
MP_ROUNDS = 2            # windows each way, unsharded and sharded in turns


class region_records:
    """Inside the block, every region kernel launch recorded: its plan,
    weights, input (the extended slab as the kernel read it) and output,
    for `held_to_plain` after the block."""

    def __enter__(self):
        from darknet_tpu_torch.ops.cuda import fused_region as kfr

        self.kfr, self.records = kfr, []
        self.orig = (kfr._prepared, kfr.launch)
        prep, launch = self.orig
        pending = {}

        def prepared(plan, weights, biases, dtype, device):
            pending["op"] = (plan, list(weights), list(biases), dtype)
            return prep(plan, weights, biases, dtype, device)

        def launched(kp, tab, wbuf, bbuf, x, out_c):
            y = launch(kp, tab, wbuf, bbuf, x, out_c)
            self.records.append((pending.pop("op"), x, y))
            return y

        kfr._prepared, kfr.launch = prepared, launched
        return self

    def __exit__(self, *exc):
        self.kfr._prepared, self.kfr.launch = self.orig

    def held_to_plain(self, init):
        """(the largest error of a launch relative to its plain version's
        scale, every launch within tolerance, the input heights); the
        records go.  f32: TOL_F32 of the scale, on the launch's own
        operands.  bf16 on the launch's own probe weights, where one
        rounding carried through the nine steps reaches 0.0093-0.0095 of
        the scale (PERF.md §6): within twice the plain bf16
        version's own distance from the plain f32 one on those operands
        (two rounding chains, each that far from f32); and the kernel on
        the launch's own input (the extended slab) with phase 1's weights
        (`init`: {dtype: the graph's seeded params}) within TOL_BF16 of
        its plain version, as phases 1 and 4 hold it."""
        import torch

        from darknet_tpu_torch.ops import fused_region as fr
        from darknet_tpu_torch.ops.library import parse_plan

        worst, ok, heights = 0.0, True, []
        for (plan, ws, bs, dtype), x, y in self.records:
            sub = parse_plan(plan) if isinstance(plan, str) else plan
            want = fr.region_plain(sub, x, ws, bs, compute_dtype=dtype)
            tol = TOL_F32
            if dtype == torch.bfloat16:
                f32 = fr.region_plain(sub, x.float(), [w.float() for w in ws],
                                      bs, compute_dtype=torch.float32)
                own = float((want.float() - f32).abs().max())
                tol = max(TOL_BF16, 2 * own / float(want.float().abs().max()))
                w0, b0 = fr.step_weights(sub.steps, init[dtype], dtype)
                y0 = self.kfr.region_call(plan, x, w0, b0, compute_dtype=dtype)
                p0 = fr.region_plain(sub, x, w0, b0, compute_dtype=dtype)
                err0, scale0, _s, good0 = held_to_plain(y0, p0, TOL_BF16)
                worst = max(worst, err0 / max(scale0, 1e-30))
                ok = ok and good0
            err, scale, _share, good = held_to_plain(y, want, tol)
            worst = max(worst, err / max(scale, 1e-30))
            ok = ok and good
            heights.append(int(x.shape[1]))
        self.records = []
        return worst, ok, heights


def head_gap(got, want):
    """Per head: the largest difference over the head's spread (max -
    min) and over its largest value."""
    out = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float().to(a.device)
        d = float((a - b).abs().max())
        out.append((d / float(b.max() - b.min()), d / float(b.abs().max())))
    return out


def heads_ok(label, heads, ref, ref_f32):
    """(ok, what): f32 heads within TOL_F32 of each head's spread of the
    reference's; bf16 and int8 within the reference's own distance from
    f32 (over each spread): two correct runs of a reduced precision,
    whose sums or conv algorithms differ, part by as much as either
    parts from f32 (a rounding, or an int8 step, carried through ~160
    layers on probe weights)."""
    gap = head_gap(heads, ref)
    if label == "f32":
        return (all(s <= TOL_F32 for s, _m in gap),
                f"within {TOL_F32} of each head's spread")
    yard = head_gap(ref, ref_f32)
    return (all(s <= y for (s, _m), (y, _n) in zip(gap, yard)),
            f"within the unsharded {label}'s own distance from f32 "
            f"{[round(y, 4) for y, _n in yard]} of each spread")


def mp_nets(root):
    """yolov4-608 b=8 on probe weights (phase 15's): the frames and the
    bf16, f32, calibrated int8 and dynamic int8 networks."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.weights import io as wio

    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    rng = np.random.default_rng(MP_SEED)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = rng.uniform(0, 1, shape).astype(np.float32)
    g = quiet_graph(cfg_text)
    probe = Network(g, paramlib.params_to_torch(
        g, probe_params(g), DEVICE, torch.bfloat16),
        compute_dtype=torch.bfloat16, device=DEVICE)
    with torch.inference_mode():
        raw = probe._fwd(probe.params,
                         torch.from_numpy(frames).to(DEVICE))["raw_heads"]
    bias = obj_bias_for([h.float() for h in raw], 0.25,
                        PROBE_PASS * SERVE_BATCH)
    del probe, raw
    weights = os.path.join(root, "probe.weights")
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)
    nets = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label in ("bf16", "int8", "int8dyn"):
            nets[label] = Network.from_cfg(cfg, weights=weights,
                                           int8=label != "bf16",
                                           compute_dtype=torch.bfloat16,
                                           device=DEVICE)
        nets["f32"] = Network.from_cfg(cfg, weights=weights, device=DEVICE)
    nets["int8"].calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(
        np.float32) for _ in range(INT8_CALIB_FRAMES)])
    return g, frames, nets


def mp_launches(fn, label, n_int8, init):
    """fn() once with every region and int8 launch recorded and counted:
    (result, (region, int8) launches, the region launches' worst error
    against their plain version, the input heights); every launch is held
    to its plain version (region: TOL_F32 / TOL_BF16; int8: bitwise)."""
    import torch

    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    torch.cuda.synchronize()
    with region_records() as rr, int8_records() as ir:
        kfr.launches = qm.launches = 0
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        launches = (kfr.launches, qm.launches)
    with torch.inference_mode():
        worst, ok, heights = rr.held_to_plain(init)
        q_eq, q_n = ir.bitwise_to_plain()
    require(ok, f"{label}: every region launch within its plain version's "
            f"tolerance (worst {worst:.3g} of the scale)")
    require(q_eq == q_n == launches[1] == n_int8, f"{label}: {n_int8} int8 "
            f"launches, each bitwise its plain version ({q_eq} of {q_n}, "
            f"{launches[1]} counted)")
    return out, launches, worst, heights


def mp_spatial(card, g, frames, nets, ref, init):
    """Phase 16 (a): make_spatial_forward over sp=2 and (dp=2, sp=2)."""
    import torch

    from darknet_tpu_torch.parallel.spatial import (make_spatial_forward,
                                                    make_spatial_mesh)

    out = {}
    for n_dp, n_sp in MP_SPATIAL:
        mesh = make_spatial_mesh(n_dp, n_sp,
                                 devices=[MP_DEVICE] * (n_dp * n_sp))
        cells = n_dp * n_sp
        for label, net in nets.items():
            n_q = {"int8": INT8_CONVS, "int8dyn": INT8_CONVS - 1}.get(label, 0)
            f = make_spatial_forward(g, mesh, compute_dtype=net.compute_dtype,
                                     decode=False)
            heads, launches, worst, heights = mp_launches(
                lambda: f(net.params, frames), f"spatial {label} "
                f"dp={n_dp} sp={n_sp}", n_q * cells, init)
            require(launches[0] == cells, f"spatial {label}: {cells} region "
                    f"launches a request, got {launches[0]}")
            gap = head_gap(heads, ref[label])
            finite = all(bool(torch.isfinite(h).all()) for h in heads)
            ok, what = heads_ok(label, heads, ref[label], ref["f32"])
            print(f"(a) spatial {label} dp={n_dp} sp={n_sp} ({card}): "
                  f"{launches[0]} region launches on slabs of "
                  f"{heights} input rows, worst {worst:.3g} of the scale "
                  f"against region_plain on the same slab; {launches[1]} "
                  f"int8 launches, each bitwise; heads against unsharded "
                  f"{[(round(s, 7), round(m, 7)) for s, m in gap]} (of the "
                  f"spread, of the largest), {what}: {ok}", flush=True)
            require(finite and ok, f"spatial {label} dp={n_dp} sp={n_sp}: "
                    f"heads {what}")
            out[(label, n_dp, n_sp)] = launches
    return out


def mp_tensor(card, g, frames, nets, init):
    """Phase 16 (b): make_tp_forward over tp=2 and (dp=2, tp=2)."""
    import torch

    from darknet_tpu_torch.nn.emit import make_forward
    from darknet_tpu_torch.parallel.tensor import (_tp_layers,
                                                   make_tp_forward,
                                                   make_tp_mesh)

    from darknet_tpu_torch.ops import quant_matmul as qm

    # filter shards narrower than any yolov4 conv's: yolov4-tiny's
    # 32-filter convs at tp=4 give N=8
    narrow = []
    for n in (8, 16, 32):
        for size, stride in ((1, 1), (3, 1), (3, 2)):
            ops, kw = int8_conv_operands(2, 19, 128, n, size, stride,
                                         seed=n + size + stride)
            for dt in (torch.float32, torch.bfloat16):
                got = qm.int8_conv(*ops, out_dtype=dt, **kw)
                want = qm.int8_conv_plain(*ops, out_dtype=dt, **kw)
                narrow.append(bool(torch.equal(got, want)))
    print(f"(b) int8_conv at filter shards N = 8, 16, 32 (1x1, 3x3/1, "
          f"3x3/2; f32 and bf16 out): {sum(narrow)} of {len(narrow)} "
          f"bitwise their plain version", flush=True)
    require(all(narrow), "int8_conv at narrow filter shards")
    x = torch.from_numpy(frames).to(DEVICE)
    ref = {}
    for label in ("f32", "bf16", "int8"):
        net = nets[label]
        with torch.inference_mode():
            ref[label] = make_forward(g, compute_dtype=net.compute_dtype,
                                      fuse_regions=None)(net.params,
                                                         x)["heads"]
    out = {}
    for n_dp, n_tp in MP_TENSOR:
        mesh = make_tp_mesh(n_dp, n_tp, devices=[MP_DEVICE] * (n_dp * n_tp))
        elig = _tp_layers(g, n_tp)
        q = [i for i, p in enumerate(nets["int8"].params) if "w_q" in p]
        n_sh = sum(1 for i in q if i in elig)
        for label in ("f32", "bf16", "int8"):
            net = nets[label]
            n_q = n_dp * (n_tp * n_sh + len(q) - n_sh) \
                if label == "int8" else 0
            f = make_tp_forward(g, mesh, compute_dtype=net.compute_dtype,
                                decode=False)
            heads, launches, _w, _h = mp_launches(
                lambda: f(net.params, frames),
                f"tp {label} dp={n_dp} tp={n_tp}", n_q, init)
            require(launches[0] == 0, f"tp {label}: no region launch")
            gap = head_gap(heads, ref[label])
            ok, what = heads_ok(label, heads, ref[label], ref["f32"])
            print(f"(b) tp {label} dp={n_dp} tp={n_tp} ({card}): "
                  f"{launches[0]} region, {launches[1]} int8 launches "
                  f"({n_tp} x {n_sh} sharded + {len(q) - n_sh} replicated "
                  f"a block), each bitwise; heads against the unsharded "
                  f"forward without regions "
                  f"{[(round(s, 7), round(m, 7)) for s, m in gap]}, "
                  f"{what}: {ok}", flush=True)
            require(ok, f"tp {label} dp={n_dp} tp={n_tp}: heads")
            out[(label, n_dp, n_tp)] = launches
    return out


def mp_pipeline(card, g, frames, nets, ref, init):
    """Phase 16 (c): PipelineForward over 2 and 4 stages."""
    from darknet_tpu_torch.parallel.pipeline import PipelineForward

    out = {}
    for stages, mb in MP_PIPELINE:
        for label in ("bf16", "int8"):
            net = nets[label]
            pf = PipelineForward(g, net.params, [MP_DEVICE] * stages,
                                 compute_dtype=net.compute_dtype,
                                 microbatches=mb)
            n_q = INT8_CONVS * mb if label == "int8" else 0
            heads, launches, worst, heights = mp_launches(
                lambda: pf(frames), f"pipeline {label} {stages} stages "
                f"{mb} micro-batches", n_q, init)
            require(launches[0] == mb, f"pipeline {label}: a region launch "
                    f"a micro-batch, got {launches[0]}")
            gap = head_gap(heads, ref[label])
            ok, what = heads_ok(label, heads, ref[label], ref["f32"])
            print(f"(c) pipeline {label} {stages} stages (cuts "
                  f"{pf.cuts}), {mb} micro-batches ({card}): {launches[0]} "
                  f"region launches (batch {heights and SERVE_BATCH // mb}, "
                  f"worst {worst:.3g} of the scale), {launches[1]} int8, "
                  f"each bitwise; heads against unsharded "
                  f"{[(round(s, 7), round(m, 7)) for s, m in gap]}, "
                  f"{what}: {ok}", flush=True)
            require(ok, f"pipeline {label} {stages}x{mb}: heads")
            out[(label, stages, mb)] = launches
    return out


def mp_network(card, frames, nets, init):
    """Phase 16 (d): the Network on a {"dp": 2, "sp": 2} mesh, kept sets
    against unsharded; (e) R1: dynamic int8 on a dp=2 mesh."""
    import torch

    from darknet_tpu_torch.ops import conv as convmod
    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.parallel.spatial import make_spatial_mesh

    mesh = make_spatial_mesh(2, 2, devices=[MP_DEVICE] * 4)
    out = {}
    for label in ("f32", "bf16", "int8"):
        net = nets[label]
        n_q = INT8_CONVS * 4 if label == "int8" else 0
        got, launches, _w, _h = mp_launches(
            lambda: net.submit_detect_device(frames, mesh=mesh),
            f"mesh sp {label}", n_q, init)
        with torch.inference_mode():
            whole = net.submit_detect_device(frames)
            pre_m = net.submit_detect_device(frames, nms=0, mesh=mesh)
            pre_w = net.submit_detect_device(frames, nms=0)
        ka, kb, box_err = kept_matched(got, whole)
        args = (0.25, 0.45, net._nms_kind, net._nms_beta)
        fwd = flips_explained(got, pre_m, whole, pre_w, *args)
        bwd = flips_explained(whole, pre_w, got, pre_m, *args)
        why = {}
        for r in (fwd[1], bwd[1]):
            for v in r.values():
                why[v] = why.get(v, 0) + 1
        print(f"(d) Network {label} on {mesh.shape} ({card}): {launches[0]} "
              f"region, {launches[1]} int8 launches a request; kept "
              f"{len(ka)} against the unsharded {len(kb)} (boxes within "
              f"{box_err:.3g}), {len(ka ^ kb)} differ, traced {why}, "
              f"unexplained {fwd[2] + bwd[2]} (score noise {fwd[3]:.4g})",
              flush=True)
        require(launches[0] == 4 and len(ka) > 0, f"mesh sp {label}: 4 "
                f"region launches, detections kept")
        require(not fwd[2] and not bwd[2], f"mesh sp {label}: every kept "
                f"difference traced to a decision that flipped")
        out[label] = launches
    # (e) R1: every conv's dynamic scale is the whole batch's
    net = nets["int8dyn"]
    dp2 = make_mesh(devices=[MP_DEVICE] * 2)
    orig, calls = convmod.conv2d_int8, {}

    def spy(x, p, **kw):
        scale = p["x_scale"] if "x_scale" in p else \
            convmod.input_scale(x.float())
        calls.setdefault(p["w_q"].data_ptr(), []).append(
            (x.float().abs().amax(), torch.as_tensor(scale).reshape(())))
        return orig(x, p, **kw)

    convmod.conv2d_int8 = spy
    try:
        got, launches, _w, _h = mp_launches(
            lambda: net.submit_detect_device(frames, mesh=dp2),
            "R1 dynamic int8 dp=2", (INT8_CONVS - 1) * 2, init)
    finally:
        convmod.conv2d_int8 = orig
    same = []
    for c in calls.values():
        m = torch.clamp_min(torch.stack([v[0] for v in c]).amax(), 1e-8)
        want = convmod.input_scale(m, absmax=m)
        same.append(len(c) == 2 and all(torch.equal(v[1], want) for v in c))
    with torch.inference_mode():
        whole = net.submit_detect_device(frames)
        pre_m = net.submit_detect_device(frames, nms=0, mesh=dp2)
        pre_w = net.submit_detect_device(frames, nms=0)
    ka, kb, box_err = kept_matched(got, whole)
    fwd = flips_explained(got, pre_m, whole, pre_w, 0.25, 0.45,
                          net._nms_kind, net._nms_beta)
    print(f"(e) R1 dynamic int8 on dp=2 ({card}): {sum(same)} of "
          f"{len(same)} convs quantized with the whole batch's max|x|; "
          f"{launches[1]} int8 launches; kept {len(ka)} against the "
          f"unsharded {len(kb)}, {len(ka ^ kb)} differ (unexplained "
          f"{fwd[2]}, score noise {fwd[3]:.4g})", flush=True)
    require(len(same) == INT8_CONVS - 1 and all(same), "R1: every dynamic "
            "int8 conv's scale is the whole batch's")
    require(not fwd[2], "R1: every kept difference traced to a decision")
    out["r1"] = launches
    return out


def mp_profile(fn):
    """(device busy ms, the device window's ms, device events) of one
    fn() in a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from darknet_tpu_torch.utils.profiler import device_events

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = device_events(prof.events())
    if not dev:
        return None, None, 0
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3
    return busy, span, len(dev)


def mp_rates(card, g, frames, nets):
    """Phase 16 (f): img/s of each path against unsharded in bf16, in
    turns; a profiled request of each (busy share, device events)."""
    import torch

    from darknet_tpu_torch.parallel import make_mesh
    from darknet_tpu_torch.parallel.pipeline import PipelineForward
    from darknet_tpu_torch.parallel.spatial import make_spatial_mesh
    from darknet_tpu_torch.parallel.tensor import make_tp_forward, make_tp_mesh

    net = nets["bf16"]
    x = torch.from_numpy(frames).to(DEVICE)
    sp = make_spatial_mesh(2, 2, devices=[MP_DEVICE] * 4)
    tp = make_tp_forward(g, make_tp_mesh(2, 2, devices=[MP_DEVICE] * 4),
                         compute_dtype=torch.bfloat16, decode=False)
    pf = PipelineForward(g, net.params, [MP_DEVICE] * 4,
                         compute_dtype=torch.bfloat16, microbatches=4)

    def whole_forward():
        with torch.inference_mode():
            return net._fwd(net.forward_params, x)["heads"]

    paths = {
        "mesh_sp": (lambda: net.device_out_to_dets(*net.submit_detect_device(
            frames)), lambda: net.device_out_to_dets(
                *net.submit_detect_device(frames, mesh=sp))),
        "tp": (whole_forward, lambda: tp(net.params, x)),
        "pipeline": (whole_forward, lambda: pf(x)),
    }
    out = {}
    for name, (base, sharded) in paths.items():
        rates = {"unsharded": [], name: []}
        for i in range(MP_ROUNDS):
            for way in ("unsharded", name)[::1 if i % 2 == 0 else -1]:
                req = base if way == "unsharded" else sharded
                with torch.inference_mode():
                    rates[way] += serve_rate(net, frames, request=req,
                                             **MP_RATE)[2]
        med = {w: float(np.median(r)) for w, r in rates.items()}
        with torch.inference_mode():
            prof = {w: mp_profile(f) for w, f in (("unsharded", base),
                                                  (name, sharded))}
        desc = "; ".join(
            f"{w} busy {b:.2f} of {s:.2f} ms (idle {1 - b / s:.1%}), {n} "
            f"device events" for w, (b, s, n) in prof.items() if b)
        print(f"(f) {name} bf16 ({card}): img/s {med[name]:.2f} against "
              f"unsharded {med['unsharded']:.2f} ({med[name] / med['unsharded']:.3f}"
              f"x), medians of {MP_ROUNDS} windows of {MP_RATE['requests']} "
              f"each way in turns ({name} {[round(r, 2) for r in rates[name]]}"
              f", unsharded {[round(r, 2) for r in rates['unsharded']]}); "
              f"one profiled request: {desc}", flush=True)
        out[name] = {"img_s": med, "profile": prof}
    # phase 15's path beside: the dp=2 mesh request (blocks one at a time)
    dp2 = make_mesh(devices=[MP_DEVICE] * 2)
    with torch.inference_mode():
        b, s, n = mp_profile(lambda: net.device_out_to_dets(
            *net.submit_detect_device(frames, mesh=dp2)))
    if b:
        print(f"(f) phase 15's dp=2 mesh request, bf16 ({card}): busy "
              f"{b:.2f} of {s:.2f} ms (idle {1 - b / s:.1%}), {n} device "
              f"events", flush=True)
    return out


def phase_model_parallel(card):
    """Phase 16 (`--only model_parallel`): model-parallel serving at full
    width, the card named 2 or 4 times."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        g, frames, nets = mp_nets(root)
        # phase 1's weights for the kernel checks on each launch's input
        init = {torch.bfloat16: paramlib.params_to_torch(
            g, paramlib.fuse_conv_batchnorm(
                g, paramlib.init_params(g, seed=SERVE_PX)), DEVICE,
            torch.bfloat16)}
        x = torch.from_numpy(frames).to(DEVICE)
        with torch.inference_mode():
            ref = {k: n._fwd(n.forward_params, x)["heads"]
                   for k, n in nets.items()}
        out = {"spatial": mp_spatial(card, g, frames, nets, ref, init),
               "tensor": mp_tensor(card, g, frames, nets, init),
               "pipeline": mp_pipeline(card, g, frames, nets, ref, init)}
        out["network"] = mp_network(card, frames, nets, init)
        out["rates"] = mp_rates(card, g, frames, nets)
        del nets, ref
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 16 (model parallelism) in "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return out


MPT_PIPELINE = ((2, 2), (2, 4), (4, 2), (4, 4))  # (stages, micro-batches)
MPT_TENSOR = ((1, 2), (2, 2))                     # (dp, tp)
MPT_SPATIAL = ((1, 2), (2, 2))                    # (dp, sp)
MPT_3D = (2, 2, 2)                                # (dp, sp, tp)
MPT_TIMED = 2             # steps each way, unsharded and sharded in turns
MPT_SERVED = (4, 2)       # the pipeline (stages, micro-batches) served in (f)


def mpt_unsharded(g, p0, accum, x, y, dtype=None):
    """The step without a mesh on the card from the seed's init: (params,
    momentum, cost), numpy."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step

    step = make_train_step(g, accum=accum, compute_dtype=dtype,
                           train_act_dtype=dtype)
    p = paramlib.train_params_to_torch(g, p0, DEVICE)
    o = init_opt_state(g, p)
    p, o, c, _m = step(p, o, torch.from_numpy(x).to(DEVICE),
                       torch.from_numpy(y).to(DEVICE), g.net.lr)
    return (paramlib.train_params_to_numpy(g, p),
            paramlib.train_params_to_numpy(g, o["u"]), float(c))


def mpt_pipeline_state(g, pt):
    """(params, momentum) of a PipelineTrain, numpy, merged over stages."""
    from darknet_tpu_torch.nn import params as paramlib

    u = [next((st["opt"]["u"][i] for st in pt.stages if st["opt"]["u"][i]),
              {}) for i in range(len(g.layers))]
    return (paramlib.train_params_to_numpy(g, pt.gather_params()),
            paramlib.train_params_to_numpy(g, u))


def mpt_steps(g, p0):
    """{label: (accum, make() -> run() -> (params, momentum, cost))}: the
    meshes of phase 17 (a)-(d), the card named once a mesh device; run()
    takes one step from the seed's init on the batch make() was given."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.mesh import grid_mesh
    from darknet_tpu_torch.parallel.pipeline import PipelineTrain
    from darknet_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                    make_spatial_train_step)
    from darknet_tpu_torch.parallel.tensor import (gather, gather_opt,
                                                   make_tp_train_step)
    from darknet_tpu_torch.train.step import init_opt_state

    lr = g.net.lr

    def pipeline(stages, mb):
        def make(x, y):
            pt = PipelineTrain(g, p0, [MP_DEVICE] * stages, microbatches=mb)
            xt, yt = torch.from_numpy(x).to(DEVICE), \
                torch.from_numpy(y).to(DEVICE)

            def run():
                c, _m = pt.step(xt, yt, lr)
                return mpt_pipeline_state(g, pt) + (float(c),)
            run.step = lambda: pt.step(xt, yt, lr)[0]
            run.obj = pt
            return run
        return make

    def tensor(shape, sp_axis=None):
        def make(x, y):
            mesh = grid_mesh(shape, devices=[MP_DEVICE] * int(np.prod(
                list(shape.values()))))
            step, place = make_tp_train_step(g, mesh, sp_axis=sp_axis,
                                             accum=PAR_ACCUM)
            p = paramlib.train_params_to_torch(g, p0, DEVICE)
            placed, opts, xt, yt = place(p, init_opt_state(g, p), x, y)

            def run():
                _p, _o, c, _m = step(placed, opts, xt, yt, lr)
                return (paramlib.train_params_to_numpy(g, gather(placed)),
                        paramlib.train_params_to_numpy(
                            g, gather_opt(opts)["u"]), float(c))
            run.step = lambda: step(placed, opts, xt, yt, lr)[2]
            return run
        return make

    def spatial(n_dp, n_sp):
        def make(x, y, dtype=None):
            mesh = make_spatial_mesh(n_dp, n_sp,
                                     devices=[MP_DEVICE] * (n_dp * n_sp))
            step = make_spatial_train_step(g, mesh, accum=PAR_ACCUM,
                                           compute_dtype=dtype,
                                           train_act_dtype=dtype)
            p = paramlib.train_params_to_torch(g, p0, DEVICE)
            o = init_opt_state(g, p)
            xt, yt = torch.from_numpy(x).to(DEVICE), \
                torch.from_numpy(y).to(DEVICE)

            def run():
                _p, _o, c, _m = step(p, o, xt, yt, lr)
                return (paramlib.train_params_to_numpy(g, p),
                        paramlib.train_params_to_numpy(g, o["u"]), float(c))
            run.step = lambda: step(p, o, xt, yt, lr)[2]
            return run
        return make

    out = {}
    for stages, mb in MPT_PIPELINE:
        out[f"pipeline {stages} stages x {mb}"] = (mb, pipeline(stages, mb))
    for n_dp, n_tp in MPT_TENSOR:
        out[f"tp dp={n_dp} tp={n_tp}"] = (PAR_ACCUM, tensor(
            {"dp": n_dp, "tp": n_tp}))
    for n_dp, n_sp in MPT_SPATIAL:
        out[f"sp dp={n_dp} sp={n_sp}"] = (PAR_ACCUM, spatial(n_dp, n_sp))
    n_dp, n_sp, n_tp = MPT_3D
    out[f"3D dp={n_dp} sp={n_sp} tp={n_tp}"] = (PAR_ACCUM, tensor(
        {"dp": n_dp, "sp": n_sp, "tp": n_tp}, sp_axis="sp"))
    return out


def mpt_bf16(card, name, g, p0, x, y, f32, *, held):
    """Phase 17 (c)'s bf16/act16 step on (dp=2, sp=2) against the
    unsharded bf16/act16 step on `name` (f32: the unsharded f32 step's
    (params, momentum, cost)).  Both costs within 1%.  held: the updates
    and the rolling statistics, each array's largest difference, within
    the unsharded bf16 step's own distance from f32 and within CAP of
    the update (phase 8 (a)'s form).  Not held (yolov4 at init): two
    correct bf16 steps part by the update's own size there (the
    backward's signal drowns in bf16 rounding), so only the cost is
    held and the distances are printed, the L2 ones too (`update_rel`)."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                    make_spatial_train_step)
    from darknet_tpu_torch.train.step import init_opt_state

    t0 = time.perf_counter()
    bf = torch.bfloat16
    ref = mpt_unsharded(g, p0, PAR_ACCUM, x, y, bf)
    step = make_spatial_train_step(
        g, make_spatial_mesh(2, 2, devices=[MP_DEVICE] * 4),
        accum=PAR_ACCUM, compute_dtype=bf, train_act_dtype=bf)
    p = paramlib.train_params_to_torch(g, p0, DEVICE)
    o = init_opt_state(g, p)
    _p, _o, cost, _m = step(p, o, torch.from_numpy(x).to(DEVICE),
                            torch.from_numpy(y).to(DEVICE), g.net.lr)
    got = paramlib.train_params_to_numpy(g, p)
    rel = abs(float(cost) - ref[2]) / abs(ref[2])
    ok = np.isfinite(float(cost)) and rel <= 0.01
    line = []
    for what, keys in (("updates", ("w", "b", "scales")),
                       ("stats", ("mean", "var"))):
        err, scale = update_gap(got, ref[0], p0, keys)
        own, _s = update_gap(f32[0], ref[0], p0, keys)
        l2 = update_rel(got, ref[0], p0, keys)
        l2_own = update_rel(f32[0], ref[0], p0, keys)
        line.append(f"{what} err {err:.3g} of {scale:.3g}, own distance "
                    f"from f32 {own:.3g} (L2, in the update's size: "
                    f"{l2:.4g}, own {l2_own:.4g})")
        if held:
            ok = ok and err <= min(own, CAP * scale)
    print(f"(c) {name} sp dp=2 sp=2 bf16/act16 ({card}): cost "
          f"{float(cost):.8g} against {ref[2]:.8g} (rel {rel:.3g}); "
          + "; ".join(line) + (f"; held: {ok}" if held else
                               f"; the cost held ({ok}), the updates "
                               f"printed") +
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    require(ok, f"{name}: the bf16/act16 mesh step against the unsharded "
            f"bf16/act16 step")


def mpt_hold(label, got, ref, eps, state0, card, extra=""):
    """Phase 8 (a)'s form for a chaotic graph: the sharded step's updates,
    rolling statistics and momentum within ten times the unsharded
    step's own response to a 1e-7 input change plus 1e-4, capped at 30%
    of the update; the costs within 1e-4."""
    line = []
    for what, i, keys in (("updates", 0, ("w", "b", "scales")),
                          ("stats", 0, ("mean", "var")),
                          ("momentum", 1, ("w", "b", "scales"))):
        err, scale = update_gap(got[i], ref[i], state0[i], keys)
        yard, _ = update_gap(ref[i], eps[i], state0[i], keys)
        line.append(f"{what} err {err:.3g} of {scale:.3g} (1e-7 input "
                    f"change: {yard:.3g})")
        require(scale > 0 and err <= min(YARDSTICK_V4 * yard + 1e-4 * scale,
                                         CAP * scale),
                f"{label}: the {what} agree with the step without a mesh")
    rel = abs(got[2] - ref[2]) / abs(ref[2])
    require(np.isfinite(got[2]) and rel <= 1e-4,
            f"{label}: the cost is the step without a mesh's")
    print(f"({label}) ({card}): cost {got[2]:.8g} against {ref[2]:.8g} "
          f"(rel {rel:.3g}); " + "; ".join(line) + extra, flush=True)


def mpt_profile(fn):
    """(device busy ms, the device window's ms, device events, host kernel
    launches) of one fn() in a trace, read from the trace's raw events
    (a training step's event tree takes longer to build than the step).
    The CUDA activity alone: it holds the kernels and the runtime's
    launch calls, and recording every CPU op as well would slow the
    host-bound step it measures."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, lo, hi, n_dev, n_launch = 0, None, None, 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            n_dev += 1
            busy += e.duration_ns()
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            lo = s if lo is None else min(lo, s)
            hi = t if hi is None else max(hi, t)
        elif "LaunchKernel" in e.name():
            n_launch += 1
    if not n_dev:
        return None, None, 0, n_launch
    return busy / 1e6, (hi - lo) / 1e6, n_dev, n_launch


def mpt_times(card, g, p0, x, y, steps, peaks):
    """Phase 17 (e): each mesh's step ms against the step without a mesh
    (same accum), MPT_TIMED steps each way in turns (steps of these
    shapes have run: no warm-up here, the medians); one profiled step of
    each mesh and of each step without a mesh; `peaks`, the peak memory
    of each mesh's step in (a)-(d), beside."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step

    out = {}
    plain: dict = {}
    xt, yt = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    for label, (accum, make) in steps.items():
        if accum not in plain:
            step = make_train_step(g, accum=accum)
            p = paramlib.train_params_to_torch(g, p0, DEVICE)
            o = init_opt_state(g, p)

            def base(step=step, p=p, o=o):
                return step(p, o, xt, yt, g.net.lr)[2]
            plain[accum] = (base, None)
        base, base_prof = plain[accum]
        sharded = make(x, y).step
        ms = {"unsharded": [], "mesh": []}
        for i in range(MPT_TIMED):
            for way in ("mesh", "unsharded")[::1 if i % 2 == 0 else -1]:
                fn = sharded if way == "mesh" else base
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                float(fn())
                torch.cuda.synchronize()
                ms[way].append((time.perf_counter() - t0) * 1e3)
        if base_prof is None:
            base_prof = mpt_profile(base)
            plain[accum] = (base, base_prof)
        prof = {"unsharded": base_prof, "mesh": mpt_profile(sharded)}
        med = {w: float(np.median(v)) for w, v in ms.items()}
        desc = "; ".join(
            f"{w} busy {b:.1f} of {s:.1f} ms (idle {1 - b / s:.1%}), {n} "
            f"device events, {k} host launches" for w, (b, s, n, k)
            in prof.items() if b)
        print(f"(e) {label} step ms ({card}): {med['mesh']:.1f} against "
              f"{med['unsharded']:.1f} without a mesh "
              f"({med['mesh'] / med['unsharded']:.2f}x; mesh "
              f"{[round(v, 1) for v in ms['mesh']]}, unsharded "
              f"{[round(v, 1) for v in ms['unsharded']]}, in turns); peak "
              f"{peaks[label]:.2f} GiB; one profiled step each way (accum "
              f"{accum}'s step without a mesh profiled once): {desc}",
              flush=True)
        out[label] = {"ms": ms, "peak_gib": peaks[label], "profile": prof}
        del sharded
        torch.cuda.empty_cache()
    return out


MPT_HEAD_YARDS = 3.0      # (f): yardsticks on the heads (see mpt_served)


def mpt_served(card, root, cfg_text, trained, ref_np, eps_np, init_np):
    """Phase 17 (f): params trained over a mesh, folded and served b=8
    through the Network in f32, bf16 (1 region launch each, held to
    region_plain as phase 16 holds it) and calibrated int8 (91
    launches, each bitwise its plain version).  The heads against those
    served from the step without a mesh's params: one training step
    moves the params by f32 noise that the graph amplifies (phase 8
    (a)), so the bound carries that step's own response to a 1e-7 input
    change, read on the heads (`yard`: the f32 heads of the params the
    step took from the changed input, against the step's): within
    MPT_HEAD_YARDS yardsticks plus TOL_F32 (f32), or plus the unsharded
    network's own distance from f32 (bf16, int8: phase 16's bound), of
    each spread.  Each bound must sit below the step's own move of the
    f32 heads (`init_np`'s heads against the trained ones), so that a
    network that the mesh trained wrongly, or not at all, would fail."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.weights import io as wio

    cfg = os.path.join(root, "yolov4-train.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    init = {torch.bfloat16: paramlib.params_to_torch(
        g, paramlib.fuse_conv_batchnorm(
            g, paramlib.init_params(g, seed=SERVE_PX)), DEVICE,
        torch.bfloat16)}
    rng = np.random.default_rng(MP_SEED)
    frames = rng.uniform(0, 1, (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)).astype(
        np.float32)
    calib = [rng.uniform(0, 1, (SERVE_PX, SERVE_PX, 3)).astype(np.float32)
             for _ in range(INT8_CALIB_FRAMES)]
    x = torch.from_numpy(frames).to(DEVICE)

    def nets(params, labels):
        path = os.path.join(root, "trained.weights")
        wio.save_weights(g, params, path)
        out = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for label in labels:
                out[label] = Network.from_cfg(
                    cfg, weights=path, int8=label == "int8",
                    compute_dtype=None if label == "f32" else torch.bfloat16,
                    device=DEVICE)
        if "int8" in out:
            out["int8"].calibrate_int8(calib)
        return out

    def heads(net):
        return net._fwd(net.forward_params, x)["heads"]

    labels = ("f32", "bf16", "int8")
    with torch.inference_mode():
        ref = {k: heads(n) for k, n in nets(ref_np, labels).items()}
        yard = head_gap(heads(nets(eps_np, ("f32",))["f32"]), ref["f32"])
        move = head_gap(heads(nets(init_np, ("f32",))["f32"]), ref["f32"])
    own = {k: head_gap(ref[k], ref["f32"]) for k in labels}
    for label in labels:
        bound = [MPT_HEAD_YARDS * y + (TOL_F32 if label == "f32" else o)
                 for (y, _m), (o, _n) in zip(yard, own[label])]
        require(all(b < m for b, (m, _n) in zip(bound, move)),
                f"(f) {label}: the heads' bound {bound} below the step's "
                f"own move of the heads {[m for m, _n in move]}")
    out = {}
    for name, params in trained.items():
        for label, net in nets(params, labels).items():
            n_q = INT8_CONVS if label == "int8" else 0
            got, launches, worst, _h = mp_launches(
                lambda: heads(net), f"trained {name} {label}", n_q, init)
            require(launches[0] == 1, f"trained {name} {label}: one region "
                    f"launch a request, got {launches[0]}")
            gap = head_gap(got, ref[label])
            bound = [MPT_HEAD_YARDS * y + (TOL_F32 if label == "f32"
                                           else o)
                     for (y, _m), (o, _n) in zip(yard, own[label])]
            ok = all(s <= b for (s, _m), b in zip(gap, bound))
            print(f"(f) {name}'s trained params served {label} b="
                  f"{SERVE_BATCH} ({card}): {launches[0]} region launch "
                  f"(worst {worst:.3g} of the scale against region_plain), "
                  f"{launches[1]} int8, each bitwise; heads against the "
                  f"step without a mesh's params "
                  f"{[round(s, 6) for s, _m in gap]} of each spread, bound "
                  f"{[round(b, 6) for b in bound]} (the step's 1e-7 "
                  f"yardstick on the f32 heads "
                  f"{[round(y, 6) for y, _m in yard]}, the network's own "
                  f"distance from f32 "
                  f"{[round(o, 6) for o, _n in own[label]]}; the step's own "
                  f"move of the heads {[round(m, 6) for m, _n in move]}): "
                  f"{ok}",
                  flush=True)
            require(ok and all(bool(torch.isfinite(h).all()) for h in got),
                    f"trained {name} {label}: heads")
            out[(name, label)] = launches
        torch.cuda.empty_cache()
    return out


def phase_model_parallel_train(card):
    """Phase 17 (`--only model_parallel_train`): model-parallel training
    at full width, the card named 2, 4 or 8 times."""
    import torch

    from darknet_tpu_torch.dryrun import dryrun_multichip
    from darknet_tpu_torch.nn import params as paramlib

    t_phase = time.perf_counter()
    cfg_text = par_train_cfg()
    g = quiet_graph(cfg_text, train=True)
    p0 = paramlib.init_params(g, seed=0)
    x, y = train_batch(g, PAR_BATCH, PAR_SEED)
    noise = np.random.default_rng(99).standard_normal(x.shape)
    x_eps = (x * (1 + 1e-7 * noise)).astype(np.float32)
    state0 = train_state0(g, p0)
    steps = mpt_steps(g, p0)
    refs, base_peak = {}, {}
    for accum in sorted({a for a, _m in steps.values()}):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        refs[accum] = (mpt_unsharded(g, p0, accum, x, y),
                       mpt_unsharded(g, p0, accum, x_eps, y))
        base_peak[accum] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 17: yolov4-{SERVE_PX} batch {PAR_BATCH}, f32 (TF32 off), "
          f"the steps without a mesh (accum {sorted(refs)}) in "
          f"{time.perf_counter() - t_phase:.1f} s, peak "
          f"{', '.join(f'{v:.2f}' for v in base_peak.values())} GiB",
          flush=True)
    trained, peaks, shared = {}, {}, {}
    for label, (accum, make) in steps.items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = make(x, y)
        # deterministic, as phase 18 takes these steps as its references
        with deterministic():
            got = run()
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        ref, eps = refs[accum]
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(got[0], ref[0])
                   for k in b)
        extra = ""
        obj = getattr(run, "obj", None)
        if obj is not None:
            extra = f"; cuts {obj.cuts}"
        mpt_hold(label, got, ref, eps, state0, card, extra + f"; bitwise the step without a mesh: "
                 f"{same}; peak {peaks[label]:.2f} GiB; "
                 f"{time.perf_counter() - t0:.1f} s")
        if label in (f"pipeline {MPT_SERVED[0]} stages x {MPT_SERVED[1]}",
                     "tp dp=2 tp=2"):
            trained[label] = got[0]
        if label in {v[1] for v in MPW_TRAIN.values()}:
            shared[label] = got
        del run
        torch.cuda.empty_cache()
    # (c) bf16/act16 on (dp=2, sp=2) against the unsharded bf16/act16 step
    mpt_bf16(card, "yolov4", g, p0, x, y, refs[PAR_ACCUM][0], held=False)
    g_t = quiet_graph(par_train_cfg(tiny=True), train=True)
    p0_t = paramlib.init_params(g_t, seed=0)
    x_t, y_t = train_batch(g_t, PAR_BATCH, PAR_SEED)
    mpt_bf16(card, "yolov4-tiny", g_t, p0_t, x_t, y_t,
             mpt_unsharded(g_t, p0_t, PAR_ACCUM, x_t, y_t), held=True)
    # (d) the dryrun twin
    t0 = time.perf_counter()
    dry = dryrun_multichip(8, device=DEVICE)
    require(np.isfinite(dry["cost"]) and np.isfinite(dry["pp_cost"]),
            "dryrun_multichip(8): finite costs")
    print(f"(d) dryrun_multichip(8) over {dry['mesh']} ({card}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    times = {k: steps[k] for k in ("pipeline 4 stages x 4",)}
    t0 = time.perf_counter()
    out = {"times": mpt_times(card, g, p0, x, y, times, peaks),
           "peaks": peaks, "base_peaks": base_peak,
           "shared": {"steps": shared,
                      "eps": {a: r[1] for a, r in refs.items()}}}
    print(f"(e) in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_mpt_")
    try:
        out["served"] = mpt_served(card, root, cfg_text, trained,
                                   refs[PAR_ACCUM][0][0],
                                   refs[PAR_ACCUM][1][0], p0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"(f) in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 17 (model-parallel training) in "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return out


MPW_DEVICES = ("cuda:0",) * 4      # phase 18's gloo ranks, sharing the card
MPW_TIMED = 2            # (c): world and one-process runs each, in turns
MPW_SPAWN_S = 900
MPW_SERVE = {            # (a): label -> the grid's shape
    "sp": {"dp": 2, "sp": 2}, "tp": {"dp": 2, "tp": 2}, "pipe": {"pp": 4}}
MPW_MB = 4               # the pipeline's micro-batches
MPW_TRAIN = {            # (b): label -> (grid shape, phase 17's label)
    "pipeline": ({"pp": 4}, "pipeline 4 stages x 4"),
    "tp": ({"dp": 2, "tp": 2}, "tp dp=2 tp=2"),
    "sp": ({"dp": 2, "sp": 2}, "sp dp=2 sp=2")}
MPW_TIMED_STEPS = ("pipeline",)          # (c)'s steps in turns
MPW_TIMED_SERVE = ("sp", "pipe")         # (c)'s requests in turns


class exchange_clock:
    """Inside the block, the host seconds this process spends in the
    exchanges: torch.distributed's point-to-point and collective calls
    and `ops/collective.flush` (waiting for posted sends)."""

    NAMES = ("recv", "isend", "all_reduce", "all_gather",
             "all_gather_object", "barrier")

    def __enter__(self):
        import torch.distributed as dist

        from darknet_tpu_torch.ops import collective

        self.s, self.n = 0.0, 0
        self.saved = [(dist, k, getattr(dist, k)) for k in self.NAMES] + \
            [(collective, "flush", collective.flush)]
        for mod, k, fn in self.saved:
            setattr(mod, k, self._timed(fn))
        return self

    def _timed(self, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0
                self.n += 1
        return call

    def __exit__(self, *exc):
        for mod, k, fn in self.saved:
            setattr(mod, k, fn)


def mpw_launches(fn, label, init):
    """`mp_launches` in one rank of a world: fn() once with this rank's
    region and int8 launches recorded and counted, each region launch
    held to its plain version on its own input, each int8 launch bitwise
    its plain version; (result, (region, int8), worst, input heights)."""
    import torch

    from darknet_tpu_torch.ops import quant_matmul as qm
    from darknet_tpu_torch.ops.cuda import fused_region as kfr

    torch.cuda.synchronize()
    with region_records() as rr, int8_records() as ir:
        kfr.launches = qm.launches = 0
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        launches = (kfr.launches, qm.launches)
    with torch.inference_mode():
        worst, ok, heights = rr.held_to_plain(init)
        q_eq, q_n = ir.bitwise_to_plain()
    require(ok, f"{label}: every region launch within its plain version's "
            f"tolerance (worst {worst:.3g} of the scale)")
    require(q_eq == q_n == launches[1], f"{label}: every int8 launch "
            f"bitwise its plain version ({q_eq} of {q_n}, {launches[1]} "
            f"counted)")
    return out, launches, worst, heights


def mpw_turns(world_fn, one_fn, rank, group):
    """(c): world_fn() (every rank of `group`) and one_fn() (rank 0 alone,
    the others waiting) MPW_TIMED times each in turns: (rank 0's ms of
    each, and the last world run's exchanges: their ms and calls)."""
    import torch
    import torch.distributed as dist

    ms = {"world": [], "one": []}
    ex = None
    for i in range(MPW_TIMED):
        for way in ("world", "one")[::1 if i % 2 == 0 else -1]:
            torch.cuda.synchronize()
            dist.barrier(group=group)
            t0 = time.perf_counter()
            if way == "world":
                with exchange_clock() as clk:
                    world_fn()
                    torch.cuda.synchronize()
                ex = (clk.s * 1e3, clk.n)
            elif rank == 0:
                one_fn()
            torch.cuda.synchronize()
            ms[way].append((time.perf_counter() - t0) * 1e3)
            dist.barrier(group=group)
    return {"ms": ms, "exchanges": ex}


def mpw_serve(rank, root, init):
    """Phase 18 (a): yolov4-608 b=8 on phase 16's probe weights, bf16 and
    calibrated int8, through (dp=2, sp=2) of the Network's
    submit_detect_device (each rank passes its dp block; the served
    triples gathered over dp), (dp=2, tp=2) of make_tp_forward and the
    4-stage PipelineForward; rank 0 then runs phase 16's one-process mesh
    of each shape and holds the world's triple (sp) or heads to it.  (c):
    the bf16 requests' ms against the one-process mesh's, in turns
    (MPW_TIMED_SERVE)."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.parallel.mesh import world_mesh
    from darknet_tpu_torch.parallel.multihost import make_global_batch
    from darknet_tpu_torch.parallel.pipeline import PipelineForward
    from darknet_tpu_torch.parallel.spatial import make_spatial_mesh
    from darknet_tpu_torch.parallel.tensor import (make_tp_forward,
                                                   make_tp_mesh)

    meshes = {k: world_mesh(v, devices=list(MPW_DEVICES))
              for k, v in MPW_SERVE.items()}
    frames = np.load(os.path.join(root, "frames.npy"))
    cfg, weights = (os.path.join(root, n) for n in ("yolov4.cfg",
                                                    "probe.weights"))
    nets = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label in ("bf16", "int8"):
            nets[label] = Network.from_cfg(cfg, weights=weights,
                                           int8=label == "int8",
                                           compute_dtype=torch.bfloat16,
                                           device=DEVICE)
    nets["int8"].load_calibration(os.path.join(root, "int8.cache"))
    g = nets["bf16"].graph
    ones = {"sp": make_spatial_mesh(2, 2, devices=[MP_DEVICE] * 4),
            "tp": make_tp_mesh(2, 2, devices=[MP_DEVICE] * 4)}
    x = torch.from_numpy(frames)
    per = SERVE_BATCH // 2

    def paths(net):
        m = meshes["sp"]
        b = m.coords["dp"]
        cd = net.compute_dtype
        tp_w = make_tp_forward(g, meshes["tp"], compute_dtype=cd,
                               decode=False)
        tp_1 = make_tp_forward(g, ones["tp"], compute_dtype=cd,
                               decode=False)
        pf_w = PipelineForward(g, net.params, mesh=meshes["pipe"],
                               compute_dtype=cd, microbatches=MPW_MB)
        pf_1 = PipelineForward(g, net.params, [MP_DEVICE] * 4,
                               compute_dtype=cd, microbatches=MPW_MB)

        def sp_w():
            triple = net.submit_detect_device(x[b * per:(b + 1) * per],
                                              mesh=m)
            return [make_global_batch(m, t, "dp") for t in triple]

        def sp_1():
            return list(net.submit_detect_device(x, mesh=ones["sp"]))
        return {"sp": (sp_w, sp_1), "tp": (lambda: tp_w(net.params, x),
                                           lambda: tp_1(net.params, x)),
                "pipe": (lambda: pf_w(x), lambda: pf_1(x))}

    out, f32 = {}, None
    for label, net in nets.items():
        for name, (world, one) in paths(net).items():
            heads, launches, worst, heights = mpw_launches(
                world, f"rank {rank} {name} {label}", init)
            rec = {"launches": launches, "worst": worst,
                   "heights": heights}
            if rank == 0:
                from darknet_tpu_torch.ops import quant_matmul as qm
                from darknet_tpu_torch.ops.cuda import fused_region as kfr

                kfr.launches = qm.launches = 0
                with torch.inference_mode():
                    want = one()
                torch.cuda.synchronize()
                rec["one_launches"] = (kfr.launches, qm.launches)
                same = len(heads) == len(want) and all(
                    torch.equal(a, b) for a, b in zip(heads, want))
                rec["bitwise"] = same
                if name == "sp":
                    # the served triple: bitwise, as the slabs' heads are
                    rec["gap"] = [(float((a.float() - b.float()).abs().max()),
                                   0.0) for a, b in zip(heads, want)]
                    rec["within"] = (same, "the served triple")
                else:
                    rec["gap"] = head_gap(heads, want)
                if not same and name != "sp":
                    if f32 is None:
                        with warnings.catch_warnings():
                            warnings.simplefilter("ignore")
                            fn = Network.from_cfg(cfg, weights=weights,
                                                  device=DEVICE)
                        with torch.inference_mode():
                            f32 = fn._fwd(fn.forward_params,
                                          x.to(DEVICE))["heads"]
                        del fn
                    rec["within"] = heads_ok(label, heads, want, f32)
                rec["finite"] = all(bool(torch.isfinite(h).all())
                                    for h in heads)
            out[f"{name} {label}"] = rec
    # (c) the bf16 requests against the one-process mesh's, in turns
    times = {}
    group = meshes["sp"].group
    for name, (world, one) in paths(nets["bf16"]).items():
        if name in MPW_TIMED_SERVE:
            with torch.inference_mode():
                times[name] = mpw_turns(world, one, rank, group)
    return out, times


def mpw_state(g, mesh, kind, obj):
    """(params, momentum) of a world step, numpy, whole on every rank."""
    import torch.distributed as dist

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.tensor import gather, gather_opt

    if kind == "pipeline":
        own = {i: {k: v.detach().cpu() for k, v in u.items()} for i, u in
               enumerate(obj.stages[obj.stage]["opt"]["u"]) if u}
        every = [None] * len(obj.ranks)
        dist.all_gather_object(every, own, group=obj.group)
        u = [{} for _ in g.layers]
        for d in every:
            for i, v in d.items():
                u[i] = u[i] or v
        return (paramlib.train_params_to_numpy(g, obj.gather_params()),
                paramlib.train_params_to_numpy(g, u))
    placed, opts = obj
    if kind == "sp":
        return (paramlib.train_params_to_numpy(g, placed[0]),
                paramlib.train_params_to_numpy(g, opts[0]["u"]))
    return (paramlib.train_params_to_numpy(g, gather(placed, mesh=mesh,
                                                     graph=g)),
            paramlib.train_params_to_numpy(
                g, gather_opt(opts, mesh=mesh, graph=g)["u"]))


def mpw_train(rank, root):
    """Phase 18 (b): one step of each MPW_TRAIN kind from phase 15's init
    at global batch 8, subdivisions 2 (the pipeline: 4 micro-batches),
    f32 with TF32 off and cuDNN's deterministic algorithms, over the 4
    ranks; its ms on rank 0 (synchronised); rank
    0 takes phase 17's one-process step of the same mesh (its ms beside)
    and holds the world's to it (bitwise, else phase 8 (a)'s form
    against the step without a mesh and its response to a 1e-7 input
    change).  The pipeline's params, gathered, are served once in bf16
    (rank 0).  (c) for MPW_TIMED_STEPS: step ms against the one-process
    mesh's, in turns."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.parallel.mesh import world_mesh
    from darknet_tpu_torch.parallel.pipeline import PipelineTrain
    from darknet_tpu_torch.parallel.spatial import make_spatial_train_step
    from darknet_tpu_torch.parallel.tensor import make_tp_train_step
    from darknet_tpu_torch.train.step import init_opt_state

    cfg_text = par_train_cfg()
    g = quiet_graph(cfg_text, train=True)
    p0 = paramlib.init_params(g, seed=0)
    x, y = train_batch(g, PAR_BATCH, PAR_SEED)
    xt, yt = torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE)
    lr = g.net.lr
    one_steps = mpt_steps(g, p0) if rank == 0 else {}
    # phase 17's one-process steps and yardsticks where it ran first
    shared = {"steps": {}, "eps": {}}
    if rank == 0 and os.path.exists(os.path.join(root, "phase17.pkl")):
        import pickle

        with open(os.path.join(root, "phase17.pkl"), "rb") as f:
            shared = pickle.load(f)
    out, times, trained, eps = {}, {}, None, shared["eps"]
    for kind, (shape, label) in MPW_TRAIN.items():
        n = int(np.prod(list(shape.values())))
        mesh = world_mesh(shape, devices=list(MPW_DEVICES))

        def make():
            if kind == "pipeline":
                pt = PipelineTrain(g, p0, mesh=mesh, microbatches=MPW_MB)
                return pt, lambda: pt.step(xt, yt, lr)[0]
            p = paramlib.train_params_to_torch(g, p0, DEVICE)
            o = init_opt_state(g, p)
            if kind == "sp":
                step = make_spatial_train_step(g, mesh, accum=PAR_ACCUM)
                return ([p], [o]), lambda: step(p, o, xt, yt, lr)[2]
            step, place = make_tp_train_step(
                g, mesh, sp_axis="sp" if "sp" in shape else None,
                accum=PAR_ACCUM)
            placed, opts = place(p, o)
            return (placed, opts), lambda: step(placed, opts, xt, yt, lr)[2]

        with deterministic():
            obj, step = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cost = float(step())
            rec = {"ms": (time.perf_counter() - t0) * 1e3, "cost": cost,
                   "ranks": n}
            params, u = mpw_state(g, mesh, kind, obj)
        if kind == "pipeline":
            trained = params
        if rank == 0:
            ref = shared["steps"].get(label)
            rec["one_ms"] = None
            if ref is None:
                with deterministic():
                    run = one_steps[label][1](x, y)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ref = run()
                    rec["one_ms"] = (time.perf_counter() - t0) * 1e3
                del run
            same = cost == ref[2] and all(
                np.array_equal(a[k], b[k]) for a, b in zip(params, ref[0])
                for k in b)
            rec.update(bitwise=same, one_cost=ref[2])
            if not same:
                accum = MPW_MB if kind == "pipeline" else PAR_ACCUM
                if accum not in eps:
                    noise = np.random.default_rng(99).standard_normal(
                        x.shape)
                    x_eps = (x * (1 + 1e-7 * noise)).astype(np.float32)
                    with deterministic():
                        eps[accum] = mpt_unsharded(g, p0, accum, x_eps, y)
                rec["held"] = (ref, eps[accum])
                rec["got"] = (params, u, cost)
        out[kind] = rec
        if kind in MPW_TIMED_STEPS:
            with deterministic():
                one = one_steps[label][1](x, y).step if rank == 0 else None
                times[kind] = mpw_turns(step, one, rank, mesh.group)
        del obj, step
        torch.cuda.empty_cache()
    served = None
    if trained is not None and rank == 0:
        served = mpw_serve_trained(root, cfg_text, trained)
    return out, times, served


def mpw_serve_trained(root, cfg_text, trained):
    """The pipeline-trained params folded and served b=8 in bf16 through
    the Network: (region launches, worst against region_plain, finite)."""
    import torch

    from darknet_tpu_torch import Network
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.weights import io as wio

    cfg = os.path.join(root, "yolov4-train.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    g = quiet_graph(cfg_text)
    path = os.path.join(root, "trained.weights")
    wio.save_weights(g, trained, path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cfg, weights=path,
                               compute_dtype=torch.bfloat16, device=DEVICE)
    frames = np.load(os.path.join(root, "frames.npy"))
    xt = torch.from_numpy(frames).to(DEVICE)
    heads, launches, worst, _h = mpw_launches(
        lambda: net._fwd(net.forward_params, xt)["heads"],
        "pipeline-trained bf16", mpw_init(g))
    return launches, worst, all(bool(torch.isfinite(h).all()) for h in heads)


def mpw_init(g):
    """Phase 1's seeded bf16 params of `g`, for the region kernel's check
    on each launch's own input (`region_records.held_to_plain`)."""
    import torch

    from darknet_tpu_torch.nn import params as paramlib

    return {torch.bfloat16: paramlib.params_to_torch(
        g, paramlib.fuse_conv_batchnorm(
            g, paramlib.init_params(g, seed=SERVE_PX)), DEVICE,
        torch.bfloat16)}


def mpw_rank(rank, root):
    """A rank of phase 18's world of 4 gloo ranks on the card: (a), (b)
    and (c).  Each rank writes what it recorded to `mpw_<rank>.pkl`; rank
    0 also the comparisons."""
    import pickle

    import torch

    t_in = time.perf_counter()
    g = quiet_graph(open(os.path.join(root, "yolov4.cfg")).read())
    out = {}
    out["serve"], out["serve_times"] = mpw_serve(rank, root, mpw_init(g))
    torch.cuda.empty_cache()
    out["train"], out["train_times"], out["served"] = mpw_train(rank, root)
    out["s"] = time.perf_counter() - t_in
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(root, f"mpw_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mpw_setup(root):
    """Phase 16's probe weights and calibration of yolov4-608, written to
    `root` (yolov4.cfg, probe.weights, int8.cache, frames.npy)."""
    import torch

    from darknet_tpu_torch import Network, model_zoo
    from darknet_tpu_torch.nn import params as paramlib
    from darknet_tpu_torch.weights import io as wio

    cfg_text = model_zoo.yolov4_cfg(SERVE_PX, SERVE_PX)
    cfg = os.path.join(root, "yolov4.cfg")
    with open(cfg, "w") as f:
        f.write(cfg_text)
    rng = np.random.default_rng(MP_SEED)
    shape = (SERVE_BATCH, SERVE_PX, SERVE_PX, 3)
    frames = rng.uniform(0, 1, shape).astype(np.float32)
    np.save(os.path.join(root, "frames.npy"), frames)
    g = quiet_graph(cfg_text)
    probe = Network(g, paramlib.params_to_torch(
        g, probe_params(g), DEVICE, torch.bfloat16),
        compute_dtype=torch.bfloat16, device=DEVICE)
    with torch.inference_mode():
        raw = probe._fwd(probe.params,
                         torch.from_numpy(frames).to(DEVICE))["raw_heads"]
    bias = obj_bias_for([h.float() for h in raw], 0.25,
                        PROBE_PASS * SERVE_BATCH)
    del probe, raw
    weights = os.path.join(root, "probe.weights")
    wio.save_weights(g, unfolded(g, probe_params(g, obj_bias=bias)), weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q = Network.from_cfg(cfg, weights=weights, int8=True,
                             compute_dtype=torch.bfloat16, device=DEVICE)
    q.calibrate_int8([rng.uniform(0, 1, shape[1:]).astype(np.float32)
                      for _ in range(INT8_CALIB_FRAMES)])
    q.save_calibration(os.path.join(root, "int8.cache"))
    del q
    torch.cuda.empty_cache()


def phase_model_parallel_mp(card, shared=None):
    """Phase 18 (`--only model_parallel_mp`): the model-parallel meshes
    across processes, gloo ranks sharing the card.  `shared`: phase 17's
    one-process steps of the same meshes and its steps' 1e-7 yardsticks
    (taken with cuDNN's deterministic algorithms, as phase 18's are),
    which rank 0 then holds the world's steps to instead of taking them
    again."""
    import pickle

    from darknet_tpu_torch.parallel.multihost import spawn

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_mpw_")
    try:
        if shared is not None:
            with open(os.path.join(root, "phase17.pkl"), "wb") as f:
                pickle.dump(shared, f)
        mpw_setup(root)
        t0 = time.perf_counter()
        print(f"phase 18: set-up in {t0 - t_phase:.1f} s", flush=True)
        spawn(mpw_rank, list(MPW_DEVICES), root, timeout_s=MPW_SPAWN_S)
        ranks = []
        for r in range(len(MPW_DEVICES)):
            with open(os.path.join(root, f"mpw_{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        print(f"phase 18: the {len(MPW_DEVICES)}-rank world in "
              f"{time.perf_counter() - t0:.1f} s (rank 0's run "
              f"{ranks[0]['s']:.1f} s; peaks "
              f"{[round(r['peak_gib'], 2) for r in ranks]} GiB)", flush=True)
        out = mpw_report(card, ranks)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 18 (model-parallel meshes across processes) in "
          f"{time.perf_counter() - t_phase:.1f} s ({card})", flush=True)
    return out


def mpw_report(card, ranks):
    """Phase 18's lines and checks from the ranks' records; the launches
    by rank for the kernels line."""
    out = {"serve": {}, "train": {}}
    # (a)
    for key, rec0 in ranks[0]["serve"].items():
        name, label = key.split()
        per = [r["serve"][key]["launches"] for r in ranks]
        total = (sum(p[0] for p in per), sum(p[1] for p in per))
        n_q = INT8_CONVS if label == "int8" else 0
        if name == "pipe":
            require(per[0][0] == MPW_MB and all(p[0] == 0 for p in per[1:]),
                    f"{key}: a region launch a micro-batch on stage 0's "
                    f"rank alone, got {[p[0] for p in per]}")
            require(total[1] == n_q * MPW_MB, f"{key}: {n_q * MPW_MB} int8 "
                    f"launches over the stages, got {total[1]}")
        else:
            want_r = 1 if name == "sp" else 0
            require(all(p == (want_r, n_q) for p in per),
                    f"{key}: {want_r} region and {n_q} int8 launches on "
                    f"every rank, got {per}")
        one = tuple(rec0["one_launches"])
        if name != "tp":
            require(total == one, f"{key}: the world's launches {total} "
                    f"are the one-process mesh's {one}")
        within = rec0.get("within", (True, "bitwise"))
        print(f"(a) {key} over 4 ranks ({card}): launches by rank "
              f"{per} (the one-process mesh {one}), each region launch "
              f"held to region_plain on its own input (worst "
              f"{max(r['serve'][key]['worst'] for r in ranks):.3g} of the "
              f"scale; slabs of {rec0['heights']} rows on rank 0), each "
              f"int8 launch bitwise; "
              f"{'served triple' if name == 'sp' else 'heads'} against "
              f"the one-process mesh: "
              f"bitwise {rec0['bitwise']}, gap "
              f"{[(round(a, 7), round(b, 7)) for a, b in rec0['gap']]} "
              f"({within[1]})", flush=True)
        require(rec0["finite"] and (rec0["bitwise"] or within[0]),
                f"{key}: heads against the one-process mesh")
        out["serve"][key] = per
    # (b)
    state0 = None
    for kind, rec in ranks[0]["train"].items():
        label = MPW_TRAIN[kind][1]
        costs = [r["train"][kind]["cost"] for r in ranks[:rec["ranks"]]]
        require(len(set(costs)) == 1, f"{kind}: every rank's cost is the "
                f"same, got {costs}")
        if not rec["bitwise"]:
            if state0 is None:
                state0 = mpw_state0()
            ref, eps = rec["held"]
            mpt_hold(f"18 (b) {label}", rec["got"], ref, eps, state0, card,
                     f"; {rec['ranks']} ranks")
        one = "phase 17's" if rec["one_ms"] is None else \
            f"{rec['one_ms']:.1f} ms with its numpy state out"
        print(f"(b) {label} over {rec['ranks']} ranks ({card}): step "
              f"{rec['ms']:.1f} ms (rank 0, the first; the one-process "
              f"mesh's first: {one}); cost "
              f"{rec['cost']:.8g} against the one-process mesh's "
              f"{rec['one_cost']:.8g}; bitwise {rec['bitwise']}",
              flush=True)
        out["train"][kind] = rec["bitwise"]
    launches, worst, finite = ranks[0]["served"]
    print(f"(b) the pipeline-trained params served bf16 b={SERVE_BATCH} "
          f"({card}): {launches[0]} region launch (worst {worst:.3g} of the "
          f"scale against region_plain), finite heads {finite}", flush=True)
    require(launches[0] == 1 and finite, "pipeline-trained params served")
    out["served"] = launches
    # (c)
    for what, key in (("bf16 request", "serve_times"),
                      ("step", "train_times")):
        for name, t in ranks[0][key].items():
            ms = t["ms"]
            ex_ms, n_ex = t["exchanges"]
            med = {w: float(np.median(v)) for w, v in ms.items()}
            print(f"(c) {name} {what} ms ({card}): {med['world']:.1f} over "
                  f"4 ranks against {med['one']:.1f} on the one-process "
                  f"mesh ({med['world'] / med['one']:.2f}x; "
                  f"{[round(v, 1) for v in ms['world']]} and "
                  f"{[round(v, 1) for v in ms['one']]}, in turns); rank "
                  f"0's last world {what}: {ex_ms:.1f} ms "
                  f"({ex_ms / ms['world'][-1]:.1%}) in {n_ex} exchange "
                  f"calls", flush=True)
    return out


def mpw_state0():
    """Phase 15's init as train_state0 gives it."""
    from darknet_tpu_torch.nn import params as paramlib

    g = quiet_graph(par_train_cfg(), train=True)
    return train_state0(g, paramlib.init_params(g, seed=0))


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="smoke run on one card")
    parser.add_argument("--only", choices=["video", "gaussian", "v1", "cli",
                                           "export", "parallel",
                                           "model_parallel",
                                           "model_parallel_train",
                                           "model_parallel_mp"],
                        help="build the kernels and run this phase alone "
                             "(no kernels line, no contract line)")
    only = parser.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print("card", card, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)

    from darknet_tpu_torch.ops.cuda import build

    build.build(KERNELS)
    for name in KERNELS:
        build.load(name)
        log = build.build_log[name]
        print(f"built {name} with nvcc in {log['seconds']:.2f} s -> "
              f"{log['so']}", flush=True)
        print(log["ptxas"].strip(), flush=True)

    if only is not None:
        {"video": phase_video, "gaussian": phase_gaussian,
         "v1": phase_v1, "cli": phase_cli,
         "export": phase_export, "parallel": phase_parallel,
         "model_parallel": phase_model_parallel,
         "model_parallel_train": phase_model_parallel_train,
         "model_parallel_mp": phase_model_parallel_mp}[only](card)
        print(card, flush=True)
        print(json.dumps({"only": only, "ok": True}), flush=True)
        return 0
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = round(time.perf_counter() - t0, 1)
        return out

    timed(phase_kernels)
    serve = timed(phase_serve, card)
    epi = serve["epilogue"]
    timed(phase_int8_kernel)
    int8 = timed(phase_int8_serve, card, serve["img_s"])
    timed(phase_train_parity)
    timed(phase_train_full, card)
    timed(phase_zoo, card)
    timed(phase_validate, card)
    timed(phase_video, card)
    timed(phase_gaussian, card)
    timed(phase_v1, card)
    cli = timed(phase_cli, card)
    export = timed(phase_export, card)
    par = timed(phase_parallel, card)
    mp = timed(phase_model_parallel, card)
    mpt = timed(phase_model_parallel_train, card)
    served = mpt["served"]
    mpw = timed(phase_model_parallel_mp, card, mpt["shared"])["serve"]

    print(f"phase seconds ({card}): {json.dumps(seconds)}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_region", "route": "cuda",
        "source": "darknet_tpu_torch/csrc/fused_region.cu",
        "replaces": "darknet_tpu/ops/pallas/fused_region.py:759",
        "launches": serve["launches"],
        "max_abs_err": serve["max_abs_err"],
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": None,
        "launches_by_path": {
            "phase4_serve_bf16": serve["launches"],
            "phase6_int8_calibrated": int8["region_launches"],
            "phase13_bench_run": cli["bench"][0],
            "phase13_region_int8_request": cli["region_int8"][0],
            "phase14_export_bf16_child": export["bf16"]["child"]["region"],
            "phase14_export_int8_child":
                export["int8"]["child"]["region"],
            "phase15_mesh_bf16": par["bf16"]["launches"][0],
            "phase15_mesh_int8": par["int8"]["launches"][0],
            "phase15_mesh_valid": par["valid"]["region"],
            "phase16_spatial_bf16": mp["spatial"][("bf16", 2, 2)][0],
            "phase16_spatial_int8": mp["spatial"][("int8", 2, 2)][0],
            "phase16_tp_int8": mp["tensor"][("int8", 2, 2)][0],
            "phase16_pipeline_bf16": mp["pipeline"][("bf16", 4, 4)][0],
            "phase16_pipeline_int8": mp["pipeline"][("int8", 4, 4)][0],
            "phase16_mesh_sp": mp["network"]["bf16"][0],
            "phase17_trained_bf16": served[("tp dp=2 tp=2", "bf16")][0],
            "phase17_trained_int8": served[("tp dp=2 tp=2", "int8")][0],
            "phase18_mp_sp_bf16": [r[0] for r in mpw["sp bf16"]],
            "phase18_mp_sp_int8": [r[0] for r in mpw["sp int8"]],
            "phase18_mp_pipeline_bf16":
                [r[0] for r in mpw["pipe bf16"]]}}, {
        "name": "int8_gemm", "route": "cuda",
        "source": "darknet_tpu_torch/csrc/int8_gemm.cu",
        "replaces": "darknet_tpu/ops/pallas/quant_matmul.py:91",
        "launches": int8["launches"],
        "max_abs_err": int8["max_abs_err"],
        "ms": int8["ms"], "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"], "bound_by": int8["bound_by"],
        "library_ms": int8["library_ms"],
        "launches_by_path": {
            "phase6_int8_calibrated": int8["launches"],
            "phase13_bench_run": cli["bench"][1],
            "phase13_region_int8_request": cli["region_int8"][1],
            "phase14_export_bf16_child": export["bf16"]["child"]["int8"],
            "phase14_export_int8_child":
                export["int8"]["child"]["int8"],
            "phase15_mesh_bf16": par["bf16"]["launches"][1],
            "phase15_mesh_int8": par["int8"]["launches"][1],
            "phase16_spatial_bf16": mp["spatial"][("bf16", 2, 2)][1],
            "phase16_spatial_int8": mp["spatial"][("int8", 2, 2)][1],
            "phase16_tp_int8": mp["tensor"][("int8", 2, 2)][1],
            "phase16_pipeline_bf16": mp["pipeline"][("bf16", 4, 4)][1],
            "phase16_pipeline_int8": mp["pipeline"][("int8", 4, 4)][1],
            "phase16_mesh_sp": mp["network"]["bf16"][1],
            "phase17_trained_bf16": served[("tp dp=2 tp=2", "bf16")][1],
            "phase17_trained_int8": served[("tp dp=2 tp=2", "int8")][1],
            "phase18_mp_sp_bf16": [r[1] for r in mpw["sp bf16"]],
            "phase18_mp_sp_int8": [r[1] for r in mpw["sp int8"]],
            "phase18_mp_pipeline_bf16":
                [r[1] for r in mpw["pipe bf16"]]}}, {
        "name": "conv_epilogue", "route": "cuda",
        "source": "darknet_tpu_torch/csrc/fused_region.cu",
        "replaces": None,
        "launches": epi["launches"],
        "max_abs_err": epi["max_abs_err"],
        "ms": epi["ms"], "plain_ms": epi["plain_ms"],
        "bound_ms": epi["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "launches_by_path": {"phase4_serve_bf16": epi["launches"]}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
