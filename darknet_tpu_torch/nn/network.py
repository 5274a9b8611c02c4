"""Network facade (`darknet_tpu/nn/network.py`), inference on torch.

    net = Network.from_cfg(cfg, weights=None, seed=0,
                           compute_dtype=torch.bfloat16, device="cuda")
    dets = net.detect(image)                              # host NMS path
    dets = net.device_out_to_dets(*net.submit_detect_device(frames))

`from_cfg` parses the cfg with the port's graph builder, loads `.weights`
through the port's `weights/io` (or draws the numpy init from `seed`),
folds BN (unless fuse=False, or train=True), and moves the params to
`device`: the CUDA card unless the caller names the CPU (without a card,
a call that does not name the CPU raises).  The serving program runs on
`device`: forward, native-order decode, objectness threshold, a stable
top-k, probabilities, and device NMS; only the top-k candidates per image
leave the device.  An unfused network saves its `.weights`
(`save_weights`, SaveWeights); a train=True network runs the training
forward (batch statistics), as the JAX package's does.  Heads may be
[yolo] or [Gaussian_yolo]; the host path's detections of an all-Gaussian
network carry the sigmas (`Detection.uc`).  A YOLOv1 [detection] head is
returned by `forward_heads` and `predict` but not decoded, as in the JAX
package: the host path gives no detections for it
(`ops/detection_v1.detection_decode` decodes it), and the device path
refuses a network without a [yolo] or [Gaussian_yolo] head.
`resize(w, h)` rebuilds the network at another input size on the same
params.  `export_serving(path)` writes the serving program as one
`torch.export` artifact, which `Network.run_exported_serving(path, x)`
runs without the cfg, the weights or the graph builder.

Serving over a mesh (`mesh=` of `detect_batch`, `detect_batch_device` and
`submit_detect_device`; `parallel/mesh.Mesh`, the dp axis): the batch
splits into equal blocks, one a device of the mesh, each device holding a
replica of the serving state (`forward_params`: the region step weights,
the int8 weights and scales); the blocks run back to back through the
same program (the region kernel and the int8 GEMM through the
`ops/library.py` ops, once a block) and the outputs are gathered in
batch order on the mesh's first device.  Over a mesh that spans
processes each rank runs its own block and every rank gathers the
whole (`parallel/multihost.make_global_batch`).  A mesh with an `sp` axis
(`parallel/spatial.make_spatial_mesh`) also splits each block's feature
maps over the block's sp devices, in one process that drives them all
(`parallel/spatial.SpatialForward`); other axes are ignored, as the JAX
package's serving shardings ignore them.  A ("dp", "sp") grid that spans
processes (`parallel/mesh.world_mesh`, one slab a rank) serves a dp
block's slabs across its sp ranks instead: each rank passes its dp
block's images, runs its own slab in lockstep with the block's other
ranks, and gets the block's outputs back, on every rank of the block.  Where a served conv has int8
weights and no calibrated input scale, its scale is the whole batch's
(the JAX package's over its mesh, where GSPMD takes max|x| over the
global batch): the blocks then run in that lockstep executor, and over
processes the ranks take the maximum together (`ops/collective.
group_max`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
import zipfile

import numpy as np
import torch

from darknet_tpu_torch.config.cfg import patch_cfg_dims
from darknet_tpu_torch.graph.builder import Graph, build_graph
from darknet_tpu_torch.nn import params as paramlib
from darknet_tpu_torch.nn.emit import make_forward, region_int8_convs
from darknet_tpu_torch.ops import nms as nmslib
from darknet_tpu_torch.ops import yolo as yoloops
from darknet_tpu_torch.utils import spans
from darknet_tpu_torch.weights import io as wio


@dataclasses.dataclass
class Detection:
    """The reference's `Detection` (box.h:68-85): relative center-format
    bbox, objectness, per-class probs and, from Gaussian heads, the four
    sigmas."""

    bbox: tuple
    objectness: float
    prob: np.ndarray
    uc: np.ndarray | None = None

    @property
    def best_class(self) -> int:
        return int(np.argmax(self.prob))

    @property
    def best_prob(self) -> float:
        return float(self.prob[self.best_class])


def detections_to_json(dets: list, frame_id: int = 0,
                       names: list | None = None,
                       filename: str | None = None) -> str:
    """Detection2Json (network.cpp:531-593): classes named `dont_show*`
    are skipped and the filename rides in the header when given."""
    objects = []
    for d in dets:
        for j in np.nonzero(d.prob > 0)[0]:
            name = (str(names[j]) if names and j < len(names)
                    else str(int(j)))
            if name.startswith("dont_show"):
                continue                       # network.cpp:556-558
            x, y, w, h = d.bbox
            objects.append({
                "class_id": int(j),
                "name": name,
                "relative_coordinates": {
                    "center_x": float(x), "center_y": float(y),
                    "width": float(w), "height": float(h),
                },
                "confidence": float(d.prob[j]),
            })
    out: dict = {"frame_id": frame_id}
    if filename is not None:
        out["filename"] = filename             # network.cpp:542-545
    out["objects"] = objects
    return json.dumps(out, indent=1)


def _to(x, device):
    """x on `device`, the copy's wait on the host counted
    (`utils/spans.count_copy`)."""
    spans.count_copy(x, device)
    return x.to(device)


# the head kinds decoded, with their decode
DECODE = {"yolo": yoloops.yolo_decode,
          "gaussian_yolo": yoloops.gaussian_yolo_decode}


class Network:
    def __init__(self, graph: Graph, params: list, *, fused: bool = True,
                 train: bool = False, compute_dtype=None, device="cuda",
                 seen: int = 0, fuse_regions="hybrid",
                 region_int8: bool = False):
        """`params`: the port's torch params (`nn/params.params_to_torch`),
        BN folded unless fused=False.  train=True runs the training
        forward (BN from the batch statistics).  region_int8: the params'
        region convs are quantized and calibrated (`calibrate_int8`)."""
        self.graph = graph
        self.net = graph.net
        self.params = params
        self.fused = fused
        self.train = train
        self.compute_dtype = compute_dtype
        self.device = paramlib.resolve_device(device)
        self.seen = seen
        self.fuse_regions = fuse_regions
        self.region_int8 = region_int8
        self._calib_absmax: dict | None = None
        self._cfg_text: str | None = None
        # int8 weights of the region convs that region_int8 quantizes
        self._region_q: dict | None = None
        # uint8 v -> v / 255, the host's correctly rounded f32 quotients
        self._u8_unit = torch.from_numpy(
            np.arange(256, dtype=np.float32) / np.float32(255)).to(
                self.device)
        self._fwd = make_forward(graph, compute_dtype=compute_dtype,
                                 fuse_regions=fuse_regions, fused_bn=fused,
                                 region_int8=region_int8, train=train)
        self._held: tuple | None = None      # `forward_params`
        # device -> (forward_params copied from, the copy, its u8 table)
        self._replicas: dict = {}
        self._sf = None                      # `_spatial`
        self._heads = graph.heads()
        decoded = [l for l in self._heads if l.kind in DECODE]
        self._nms_kind = decoded[0].nms_kind if decoded else "greedynms"
        self._nms_beta = decoded[0].beta_nms if decoded else 0.6

    @classmethod
    def from_cfg(cls, cfg, weights=None, *, train: bool = False,
                 clear: bool = False, fuse: bool | None = None,
                 seed: int = 0, compute_dtype=None, device="cuda",
                 fuse_regions="hybrid", int8: bool = False) -> "Network":
        """LoadNetwork (parser.cpp:1852-1876): parse (train=True parses the
        training batch), load or init, fold BN unless fuse=False (default:
        fold when not training), move to `device` in the compute dtype.
        clear=True resets `seen`.  int8=True also quantizes the eligible
        convs (`nn/params.quantize_conv_params`) for the int8 path
        (`ops/conv.conv_block_int8`); it needs folded inference params.
        It also quantizes the region convs aside, for
        `calibrate_int8(region_int8=True)`."""
        device = paramlib.resolve_device(device)
        graph = build_graph(cfg, train=train)
        seen = 0
        params = paramlib.init_params(graph, seed=seed)
        if weights is not None:
            loaded, seen, _version = wio.load_weights(graph, weights)
            # layers the file did not cover keep the init
            params = [p if p else ip for p, ip in zip(loaded, params)]
        if fuse is None:
            fuse = not train
        if fuse:
            params = paramlib.fuse_conv_batchnorm(graph, params)
        if int8:
            if train or not fuse:
                raise ValueError("int8 is an inference mode: it needs "
                                 "train=False and fused BN")
            region_q = paramlib.quantize_conv_params(
                graph, params, only=region_int8_convs(graph))
            params = paramlib.quantize_conv_params(graph, params)
        if clear:
            seen = 0
        tparams = paramlib.params_to_torch(
            graph, params, device, compute_dtype or torch.float32)
        net = cls(graph, tparams, fused=fuse, train=train,
                  compute_dtype=compute_dtype, device=device, seen=seen,
                  fuse_regions=fuse_regions)
        if int8:
            net._region_q = {
                i: paramlib.int8_weights_to_torch(p, device)
                for i, p in enumerate(region_q) if "w_q" in p}
        if isinstance(cfg, str) and "\n" in cfg:
            net._cfg_text = cfg
        else:
            with open(cfg) as f:
                net._cfg_text = f.read()
        return net

    @property
    def curr_iter(self) -> int:
        return self.seen // max(self.net.optimizer_batch, 1)

    def save_weights(self, path, cutoff: int | None = None) -> None:
        """SaveWeights: the unfolded params (float32; a bf16 network's
        weights as rounded to bf16) and `seen`, up to layer `cutoff`."""
        if self.fused:
            raise ValueError(
                "params have fused BN; reload with fuse=False to save")
        wio.save_weights(self.graph, paramlib.train_params_to_numpy(
            self.graph, self.params), path, seen=self.seen, cutoff=cutoff)

    # -------------------------------------------------------- int8 scales
    def calibrate_int8(self, images, *, region_int8: bool = False) -> None:
        """Static int8 activation calibration: record each quantized
        conv's input range over `images` (iterable of HWC or BHWC float
        arrays, network-sized) and store per-tensor scales, so that
        serving skips the dynamic absmax reduce in front of every
        quantized conv.  A no-op when nothing is quantized.

        region_int8 also gives int8 to the region convs that have no
        "w_q" (the JAX package's option, off by default there too).  The
        port's own definition: each region conv is quantized per output
        filter over the layer's own HWIO weights (`quantize_conv_params`'
        rule without its width filter), and the regions are planned
        without the stem fold, so layer 0 runs as its own int8 conv on
        the raw input; the int8 integers are the unpacked int8 chain's.
        The JAX package quantizes the packed weights per packed channel
        instead, a grid of the TPU's pixel-pair packing.  Every region
        conv then launches the int8 GEMM, and no region kernel runs.
        The convs that feed a head stay in floating point."""
        if not any("w_q" in p for p in self.params):
            return
        batches = []
        for im in images:
            a = np.asarray(im, dtype=np.float32)
            batches.append(a[None] if a.ndim == 3 else a)
        absmax = paramlib.calibrate_conv_input_scales(
            self.graph, self.params, batches,
            compute_dtype=self.compute_dtype, device=self.device)
        self._apply_calibration(absmax, region_int8=region_int8)

    def save_calibration(self, path) -> None:
        """Persist the calibrated per-conv input ranges: an npz keyed by
        layer index, the JAX package's file format."""
        if self._calib_absmax is None:
            raise ValueError("no calibration to save: run calibrate_int8 "
                             "first")
        # through a file object: np.savez(path) appends ".npz" to a bare
        # path, which load_calibration would then not find
        with open(path, "wb") as f:
            np.savez(f, **{str(k): np.asarray(v, np.float32)
                           for k, v in self._calib_absmax.items()})

    def load_calibration(self, path, *, region_int8: bool = False) -> None:
        """Apply input ranges saved by save_calibration."""
        data = np.load(path)
        absmax = {int(k): float(data[k]) for k in data.files}
        self._apply_calibration(absmax, region_int8=region_int8)

    def _apply_calibration(self, absmax: dict, *, region_int8: bool) -> None:
        params = self.params
        if region_int8:
            if self._region_q is None:
                raise ValueError("region_int8 needs a network built with "
                                 "int8=True")
            params = [dict(p, **self._region_q[i]) if i in self._region_q
                      else p for i, p in enumerate(params)]
        self._calib_absmax = dict(absmax)
        self.params = paramlib.x_scale_to_torch(
            paramlib.apply_conv_input_scales(params, absmax,
                                             graph=self.graph),
            self.device)
        if region_int8 and not self.region_int8:
            self.region_int8 = True
            self._fwd = make_forward(
                self.graph, compute_dtype=self.compute_dtype,
                fuse_regions=self.fuse_regions, fused_bn=self.fused,
                region_int8=True)

    # ------------------------------------------------------------- input
    def _check_shape(self, x) -> None:
        if tuple(x.shape[1:]) != (self.net.h, self.net.w, self.net.c):
            raise ValueError(
                f"input must be (H,W,C)=({self.net.h},{self.net.w},"
                f"{self.net.c}) — got {tuple(x.shape[1:])}; resize first "
                f"(darknet_tpu_torch.data.image.resize_image_cv)")

    def _prep_input(self, image) -> np.ndarray:
        """Host input: uint8 frames are [0,255] and divide by 255 here."""
        raw = np.asarray(image)
        if raw.dtype == np.uint8:
            x = raw.astype(np.float32) / 255.0
        else:
            x = np.asarray(raw, dtype=np.float32)
        if x.ndim == 3:
            x = x[None]
        self._check_shape(x)
        return x

    def _forward(self, x: np.ndarray) -> dict:
        with torch.inference_mode():
            return self._fwd(self.forward_params,
                             torch.from_numpy(x).to(self.device))

    # ----------------------------------------------------------- forward
    def predict(self, image) -> np.ndarray:
        """NetworkPredict: the final layer's output (host numpy)."""
        out = self._forward(self._prep_input(image))["output"]
        return out.float().cpu().numpy()

    def forward_heads(self, image):
        """Activated heads (host numpy) and the reference-order decode
        (boxes, obj, cls, uc) of the [yolo] and [Gaussian_yolo] heads
        concatenated (None without such a head); uc (the sigmas) when every
        decoded head is Gaussian, else None."""
        r = self._forward(self._prep_input(image))
        heads = [h.float() for h in r["heads"]]
        return [h.cpu().numpy() for h in heads], self._decode(heads)

    def _decode(self, heads, order="reference", score_dtype=None):
        pairs = [(t, l) for t, l in zip(heads, self._heads)
                 if l.kind in DECODE]
        if not pairs:
            return None
        parts = [DECODE[l.kind](t, l, self.net.w, self.net.h, order=order,
                                score_dtype=score_dtype) for t, l in pairs]
        uc = (torch.cat([p[3] for p in parts], dim=1)
              if all(l.kind == "gaussian_yolo" for _t, l in pairs)
              else None)
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1),
                torch.cat([p[2] for p in parts], dim=1), uc)

    # --------------------------------------------------------- detection
    def detect(self, image, thresh: float = 0.25, nms: float = 0.45,
               use_device_nms: bool = False) -> list:
        """Detections for ONE image (HWC, net-sized, RGB [0,1] or uint8)."""
        x = self._prep_input(image)
        if x.shape[0] != 1:
            raise ValueError("detect() is single-image; use detect_batch")
        return self.detect_batch(x, thresh=thresh, nms=nms,
                                 use_device_nms=use_device_nms)[0]

    def detect_batch(self, images, thresh: float = 0.25, nms: float = 0.45,
                     use_device_nms: bool = False, mesh=None) -> list:
        """GetNetworkBoxes + NmsSort on the host, per image; with
        use_device_nms the device serving program instead.  With `mesh`
        the forward and the decode run over the mesh (the module
        docstring), the rest on the host as without one."""
        if use_device_nms:
            return self.detect_batch_device(images, thresh=thresh, nms=nms,
                                            mesh=mesh)
        x = self._prep_input(images)
        if mesh is None:
            _heads, dec = self.forward_heads(x)
        else:
            with torch.inference_mode():
                dec = self._over_mesh(mesh, torch.from_numpy(x),
                                      self._decode_shard)
            dec = None if dec[0] is None else dec
        if dec is None:
            return [[] for _ in range(x.shape[0])]
        boxes, obj, cls = (t.float().cpu().numpy() for t in dec[:3])
        uc = dec[3].cpu().numpy() if dec[3] is not None else None
        results = []
        for b in range(x.shape[0]):
            idx = np.nonzero(obj[b] > thresh)[0]
            if idx.size == 0:
                results.append([])
                continue
            bb, oo = boxes[b][idx], obj[b][idx]
            pp = oo[:, None] * cls[b][idx]
            pp[pp <= thresh] = 0.0
            if nms > 0:
                pp = nmslib.nms_numpy(bb, pp, nms, kind=self._nms_kind,
                                      beta=self._nms_beta)
            results.append([
                Detection(bbox=tuple(float(v) for v in bb[i]),
                          objectness=float(oo[i]), prob=pp[i],
                          uc=uc[b][idx][i] if uc is not None else None)
                for i in range(idx.size) if np.any(pp[i] > 0)])
        return results

    # ------------------------------------------------------------ resize
    def resize(self, w: int, h: int) -> "Network":
        """ResizeNetwork (network.cpp:255-410): the network rebuilt at input
        size (w, h) from its cfg text, on the same param tensors.  The
        region plans are made anew for the new size; int8 weights and the
        calibration carry over (the scales are per conv, not per size)."""
        if (w, h) == (self.net.w, self.net.h):
            return self
        if self._cfg_text is None:
            raise ValueError("resize requires a Network built from a cfg")
        cfg = patch_cfg_dims(self._cfg_text, w, h)
        net = Network(build_graph(cfg, train=self.train), self.params,
                      fused=self.fused, train=self.train,
                      compute_dtype=self.compute_dtype, device=self.device,
                      seen=self.seen, fuse_regions=self.fuse_regions,
                      region_int8=self.region_int8)
        net._cfg_text = cfg
        net._calib_absmax = self._calib_absmax
        net._region_q = self._region_q
        return net

    @property
    def forward_params(self) -> list:
        """The params the inference forward reads: `self.params` with each
        region's step weights (`make_forward(...).with_step_weights`),
        made once per params list and forward, for eager serving and its
        export alike.  A forward with no regions to hold for (the
        training forward, or any callable put in its place) reads the
        params as they are."""
        held = self._held
        if held is None or held[0] is not self.params \
                or held[1] is not self._fwd:
            hold = getattr(self._fwd, "with_step_weights", None)
            held = self._held = (self.params, self._fwd, self.params
                                 if hold is None else hold(self.params))
        return held[2]

    # -------------------------------------------------------------- mesh
    def _replica(self, device):
        """(forward_params, the uint8 table) on `device`: the network's own
        on its device, else a copy made once per forward_params."""
        if device == self.device:
            return self.forward_params, self._u8_unit
        from darknet_tpu_torch.parallel.mesh import to_device

        held = self.forward_params
        rep = self._replicas.get(device)
        if rep is None or rep[0] is not held:
            rep = self._replicas[device] = (
                held, to_device(held, device), self._u8_unit.to(device))
        return rep[1], rep[2]

    @staticmethod
    def _mesh_blocks(mesh, batch: int) -> tuple:
        """(dp size, sp size) of a serving mesh, with the JAX package's
        checks (`Network._serve_shardings`); other axes are ignored."""
        axes = mesh.axis_names
        if "dp" not in axes:
            raise ValueError(f"serving mesh needs a 'dp' axis, got {axes}")
        n_sp = mesh.shape.get("sp", 1)
        n_dp = mesh.shape["dp"]
        if n_sp > 1 and mesh.group is not None:
            if not mesh.spans_world:
                raise ValueError(
                    f"a mesh of shape {mesh.shape} with an 'sp' axis over "
                    f"processes must be a grid that spans the world "
                    f"(parallel.mesh.world_mesh)")
            # over processes each rank passes its own dp block
            return n_dp, n_sp
        if batch % n_dp:
            raise ValueError(f"batch {batch} not divisible by the mesh's "
                             f"dp size {n_dp}")
        return n_dp, n_sp

    def _spatial(self):
        """The lockstep executor over this network's forward
        (`parallel/spatial.SpatialForward`), made once per forward."""
        from darknet_tpu_torch.parallel.spatial import SpatialForward

        if self._sf is None or self._sf.fwd is not self._fwd:
            if not hasattr(self._fwd, "layer"):
                raise ValueError("mesh serving runs the inference forward")
            self._sf = SpatialForward(self.graph, fwd=self._fwd)
        return self._sf

    def _dynamic_int8(self) -> bool:
        """Whether a served conv quantizes its input with a dynamic scale
        (int8 weights without a calibrated "x_scale"; never in the
        training forward)."""
        if not hasattr(self._fwd, "layer"):
            return False
        sf = self._spatial()
        return any(sf._dynamic_int8(self.params, i, l)
                   for i, l in enumerate(self.graph.layers))

    def _mesh_heads(self, blocks, group=None, lane=None) -> list:
        """The activated heads of each block, on its first device, through
        the lockstep executor: blocks are (devices, the block's batch on
        the first) and each block's maps split over its devices (over a
        `lane` of ranks, `parallel/spatial.SpatialForward.heads`, this
        rank's slab alone, its device named once)."""
        from darknet_tpu_torch.parallel.spatial import slab_rows

        split = []
        for devs, xs in blocks:
            unit = self._replica(devs[0])[1]
            if lane is not None:
                devs = lane.devs(devs[0])
            slabs = []
            for d, (lo, hi) in zip(devs, slab_rows(xs.shape[1],
                                                   len(devs))):
                if d is None:
                    slabs.append(None)
                    continue
                slab = _to(xs[:, lo:hi], d)
                if slab.dtype == torch.uint8:
                    slab = unit.to(d)[slab.int()]
                slabs.append(slab)
            split.append((devs, slabs))
        with spans.span("serve_forward"):
            return self._spatial().heads(lambda d: self._replica(d)[0],
                                         split, group=group, lane=lane)

    def _over_mesh(self, mesh, x, run, finish=None) -> tuple:
        """run(params, u8 table, block, heads) -> a tuple of tensors (or
        Nones) for each block of x over the mesh, on the block's first
        device, then finish(*that tuple) -> the block's outputs where
        given; the outputs gathered in batch order on the mesh's first
        device (over processes: this rank's block run, every rank's
        gathered).  `heads` is None where `run` runs the forward on the
        block itself, as without a mesh; with an "sp" axis, or with
        dynamic int8 scales (which the whole batch sets), the blocks run
        layer by layer in lockstep (`parallel/spatial.SpatialForward`)
        first and `heads` are the block's.  In one process every block is
        uploaded, then every block's `run` queued, before any `finish`
        (which may wait on its device) starts, so that the devices work
        at once."""
        n, n_sp = self._mesh_blocks(mesh, x.shape[0])
        per = x.shape[0] // n
        finish = finish or (lambda *outs: outs)
        lockstep = n_sp > 1 or self._dynamic_int8()
        if mesh.group is not None and n_sp > 1:
            from darknet_tpu_torch.parallel.spatial import world_lane

            # x is this rank's dp block; its slabs run over the sp ranks
            dev = mesh.devices[0]
            xs = _to(x, dev)
            lane = world_lane(mesh, height=xs.shape[1])
            heads = self._mesh_heads([((dev,), xs)], group=mesh.sub(
                "dp", "sp"), lane=lane)[0]
            return finish(*run(*self._replica(dev), xs, heads))
        if mesh.group is not None:
            from darknet_tpu_torch.parallel.multihost import \
                make_global_batch

            axis = "dp" if mesh.spans_world else None
            r = mesh.coords["dp"] if axis else mesh.rank
            dev = mesh.devices[0]
            xs = _to(x[r * per:(r + 1) * per], dev)
            heads = self._mesh_heads([((dev,), xs)], group=mesh.group)[0] \
                if lockstep else None
            outs = finish(*run(*self._replica(dev), xs, heads))
            return tuple(None if o is None else make_global_batch(mesh, o,
                                                                  axis)
                         for o in outs)
        devs = [mesh.block(b, "sp") for b in range(n)]
        blocks = [_to(x[b * per:(b + 1) * per], d[0])
                  for b, d in enumerate(devs)]
        heads = self._mesh_heads(list(zip(devs, blocks))) if lockstep \
            else [None] * n
        outs = [run(*self._replica(d[0]), xs, h)
                for d, xs, h in zip(devs, blocks, heads)]
        outs = [finish(*o) for o in outs]
        home = mesh.devices[0]
        return tuple(None if parts[0] is None else
                     torch.cat([t.to(home) for t in parts])
                     for parts in zip(*outs))

    def _decode_shard(self, params, _unit, x, heads=None) -> tuple:
        """The host path's forward and reference-order decode of a block:
        (boxes, obj, cls, uc), Nones without a decoded head; `heads` the
        block's heads where the mesh ran the forward."""
        if heads is None:
            heads = self._fwd(params, x)["heads"]
        dec = self._decode([h.float() for h in heads])
        return (None,) * 4 if dec is None else dec

    # ----------------------------------------------------------- serving
    def _serve(self, x, thresh, nms, top_k, score_dtype, params=None,
               unit=None, heads=None):
        """The device serving program: (boxes (B,K,4), obj (B,K),
        probs (B,K,classes)) on the device; `params` defaults to the
        network's own (`forward_params`), `unit` (the uint8 table) to its
        device's; `heads`, where given, are the forward's (x unused)."""
        if heads is not None:
            return self._serve_heads(heads, thresh, nms, top_k, score_dtype)
        if x.dtype == torch.uint8:
            with spans.span("serve_upload"):
                x = self._unit(x, unit)
        with spans.span("serve_forward"):
            r = self._fwd(self.forward_params if params is None else params,
                          x)
        return self._serve_heads(r["heads"], thresh, nms, top_k, score_dtype)

    def _unit(self, x, unit=None):
        """uint8 frames in [0, 1] on their device, through `unit` (the
        network's uint8 table by default); other frames as they are."""
        if x.dtype != torch.uint8:
            return x
        # frames upload as raw uint8 (1/4 of the f32 bytes) and normalize
        # on the device through the host's own quotients: x / 255 by
        # multiplication with a rounded reciprocal (as torch's CUDA
        # division by a scalar computes it) differs from the host's
        # division by one ulp for half of the 256 values
        return (self._u8_unit if unit is None else unit)[x.int()]

    def _serve_heads(self, heads, thresh, nms, top_k, score_dtype):
        """The serving program after the forward."""
        with spans.span("serve_select"):
            # a Gaussian head's sigmas stay behind: the triple is the
            # same for every head kind
            boxes, obj, cls, _uc = self._decode([h.float() for h in heads],
                                                order="native",
                                                score_dtype=score_dtype)
            obj = torch.where(obj > thresh, obj, torch.zeros_like(obj))
            k = min(top_k, obj.shape[1])
            # stable descending sort: ties rank by index, as lax.top_k does
            ov, idx = torch.sort(obj, dim=1, descending=True, stable=True)
            ov, idx = ov[:, :k], idx[:, :k]
            tb = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            tc = torch.gather(cls, 1,
                              idx[..., None].expand(-1, -1, cls.shape[-1]))
            probs = ov[..., None] * tc
            probs = torch.where(probs > thresh, probs,
                                torch.zeros_like(probs))
        return self._serve_nms(tb, ov, probs, nms)

    def _serve_nms(self, tb, ov, probs, nms):
        """The serving program's last stage, the device NMS (its loop
        reads a flag on the host every round)."""
        if nms > 0:
            with spans.span("serve_nms"):
                probs = nmslib.nms_device(tb, probs, nms,
                                          kind=self._nms_kind,
                                          beta=self._nms_beta)
        return tb, ov, probs

    def submit_detect_device(self, images, thresh: float = 0.25,
                             nms: float = 0.45, top_k: int = 256,
                             score_dtype=None, mesh=None):
        """Run the serving program and return its device triple
        (boxes, objectness, probs) without copying it to the host.  A
        torch tensor already on the device passes through with a shape
        check; a uint8 array uploads as uint8.  A network without a
        [yolo] or [Gaussian_yolo] head has nothing to decode here and
        raises ValueError before any work.  With `mesh` the batch splits
        over the mesh's devices (the module docstring); each block
        uploads to its own device and the triple is gathered on the
        mesh's first.  Over a ("dp", "sp") grid that spans processes,
        `images` are this rank's dp block and the block's triple comes
        back on every rank of the block."""
        self._require_decoded_head()
        with spans.span("serve_request", request=True), \
                torch.inference_mode():
            with spans.span("serve_upload"):
                if isinstance(images, torch.Tensor):
                    x = images if images.dim() == 4 else images[None]
                elif getattr(images, "dtype", None) == np.uint8:
                    x = np.asarray(images)
                    x = torch.from_numpy(x if x.ndim == 4 else x[None])
                else:
                    x = torch.from_numpy(self._prep_input(images))
                self._check_shape(x)
                if mesh is None:
                    x = self._unit(_to(x, self.device))
            if mesh is None:
                return self._serve(x, thresh, nms, top_k, score_dtype)
            # every block's forward is queued before any block's NMS
            return self._over_mesh(
                mesh, x, lambda p, unit, xs, heads: self._serve(
                    xs, thresh, 0, top_k, score_dtype, params=p, unit=unit,
                    heads=heads),
                lambda tb, ov, probs: self._serve_nms(tb, ov, probs, nms))

    def _require_decoded_head(self) -> None:
        if not any(l.kind in DECODE for l in self._heads):
            raise ValueError(
                f"the device serving program decodes [yolo] and "
                f"[Gaussian_yolo] heads; this network's heads are "
                f"{[l.kind for l in self._heads]}")

    # ------------------------------------------------------------ export
    def export_serving(self, path, *, batch: int = 1, thresh: float = 0.25,
                       nms: float = 0.45, top_k: int = 256,
                       score_dtype=None) -> None:
        """Write the whole serving program (forward, decode, top-k and
        device NMS, with the params as buffers) to `path` as one
        `torch.export` artifact: the counterpart of the JAX package's
        jax.export artifact.  The region kernel and the int8 GEMM are in
        it as the custom ops of `ops/library.py`, so the loaded program
        launches the same kernels as `submit_detect_device`.  Run it with
        `run_exported_serving`: that needs `darknet_tpu_torch` importable
        (the op registrations and the kernels' sources, built at first
        use) but neither the cfg, the weights nor the graph builder.  The
        artifact is specialised to the batch, the net size, the
        thresholds and the device it was exported on; one exported on the
        card refuses to load without one.  Its input is (batch, H, W, C)
        float32 in [0, 1].  A network without a [yolo] or [Gaussian_yolo]
        head raises before any work."""
        self._require_decoded_head()
        x = torch.zeros((batch, self.net.h, self.net.w, self.net.c),
                        dtype=torch.float32, device=self.device)
        program = ServingProgram(self, x, thresh=thresh, nms=nms,
                                 top_k=top_k, score_dtype=score_dtype)
        ep = torch.export.export(program, (x,))
        ep.example_inputs = None           # the zero frames are not saved
        meta = {"device": self.device.type,
                "compute_dtype": str(self.compute_dtype or torch.float32),
                "input": list(x.shape)}
        with warnings.catch_warnings():
            # channels_last weights are not "complete" to the archive
            # writer, which then saves each one's whole storage: as meant
            warnings.filterwarnings("ignore", "No complete tensor found")
            torch.export.save(ep, path,
                              extra_files={SERVING_META: json.dumps(meta)})

    @staticmethod
    def run_exported_serving(path, x):
        """Run an `export_serving` artifact on x ((B, H, W, C) float32, a
        numpy array or a tensor, moved to the artifact's device): the
        device triple (boxes (B,K,4), objectness (B,K),
        probs (B,K,classes)).  An artifact loads once per file (and again
        when the file changes); the last four loaded stay loaded."""
        program, meta = load_exported_serving(path)
        from darknet_tpu_torch.ops.conv import precise, precise_matmul

        x = torch.as_tensor(x, dtype=torch.float32).to(meta["device"])
        cd = getattr(torch, meta["compute_dtype"].split(".")[-1])
        with torch.no_grad(), precise(cd), precise_matmul(cd):
            return program(x)

    @staticmethod
    def device_out_to_dets(tb, ov, probs) -> list:
        """Materialize a device triple into per-image Detection lists."""
        tb = tb.float().cpu().numpy()
        ov = ov.float().cpu().numpy()
        probs = probs.float().cpu().numpy()
        results = []
        for b in range(tb.shape[0]):
            results.append([
                Detection(bbox=tuple(float(v) for v in tb[b, i]),
                          objectness=float(ov[b, i]), prob=probs[b, i])
                for i in range(tb.shape[1])
                if ov[b, i] > 0 and np.any(probs[b, i] > 0)])
        return results

    def detect_batch_device(self, images, thresh: float = 0.25,
                            nms: float = 0.45, top_k: int = 256,
                            mesh=None) -> list:
        """The device serving program's detections on the host, per
        image; `mesh` as in submit_detect_device."""
        return self.device_out_to_dets(
            *self.submit_detect_device(images, thresh=thresh, nms=nms,
                                       top_k=top_k, mesh=mesh))


# the artifact's own record: the device it runs on, its compute dtype (its
# convs' TF32 setting) and its input shape
SERVING_META = "darknet_tpu_torch_serving.json"
_loaded: dict = {}


class ServingProgram(torch.nn.Module):
    """A Network's device serving program as a module for `torch.export`:
    the params the program reads (`Network.forward_params`, region step
    weights included) are buffers, so the artifact saves them under their
    layer and key; forward(x) is `Network._serve` on an f32 (B, H, W, C)
    input.  Which params it reads is taken from one request on `example`:
    an int8 conv reads its int8 weights, not its float ones, and a region
    its step weights, not its layers' own, so those stay out."""

    def __init__(self, net: Network, example, *, thresh, nms, top_k,
                 score_dtype):
        super().__init__()
        self._net = net
        self._cfg = (thresh, nms, top_k, score_dtype)
        params = net.forward_params
        read = [set() for _ in params]
        with torch.no_grad():
            net._serve(example, *self._cfg, params=[
                _Reads(p, seen) for p, seen in zip(params, read)])
        self._names = []
        for i, (p, seen) in enumerate(zip(params, read)):
            names = [(k, f"p{i}_{k}") for k in p if k in seen]
            for k, name in names:
                self.register_buffer(name, p[k])
            self._names.append(names)

    def forward(self, x):
        params = [{k: getattr(self, name) for k, name in names}
                  for names in self._names]
        return self._net._serve(x, *self._cfg, params=params)


class _Reads(dict):
    """A params entry that records the keys the forward reads: a lookup, a
    `get` or an `in` that finds the key, or any walk over them all."""

    def __init__(self, entry, seen: set):
        super().__init__(entry)
        self._seen = seen

    def __getitem__(self, k):
        self._seen.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        found = super().__contains__(k)
        if found:
            self._seen.add(k)
        return found

    def get(self, k, default=None):
        return self[k] if k in self else default

    def _all(self):
        self._seen.update(super().keys())

    def __iter__(self):
        self._all()
        return super().__iter__()

    def keys(self):
        self._all()
        return super().keys()

    def items(self):
        self._all()
        return super().items()

    def values(self):
        self._all()
        return super().values()


def _read_meta(path) -> dict:
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"/extra/{SERVING_META}")]
        if not names:
            raise ValueError(f"{path}: not an export_serving artifact")
        return json.loads(z.read(names[0]))


def load_exported_serving(path):
    """(the loaded program's module, its meta) of an `export_serving`
    artifact; the ops are registered first.  An artifact exported on the
    card raises without one."""
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    if key not in _loaded:
        meta = _read_meta(path)
        paramlib.resolve_device(meta["device"])
        if len(_loaded) >= 4:
            _loaded.pop(next(iter(_loaded)))
        with warnings.catch_warnings():
            # the archive's weights are read through read-only buffers and
            # copied to the device: nothing writes to them
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable")
            _loaded[key] = (torch.export.load(path).module(), meta)
    return _loaded[key]
