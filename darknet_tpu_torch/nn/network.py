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
                     use_device_nms: bool = False) -> list:
        """GetNetworkBoxes + NmsSort on the host, per image; with
        use_device_nms the device serving program instead."""
        if use_device_nms:
            return self.detect_batch_device(images, thresh=thresh, nms=nms)
        x = self._prep_input(images)
        _heads, dec = self.forward_heads(x)
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

    # ----------------------------------------------------------- serving
    def _serve(self, x, thresh, nms, top_k, score_dtype, params=None):
        """The device serving program: (boxes (B,K,4), obj (B,K),
        probs (B,K,classes)) on the device; `params` defaults to the
        network's own (`forward_params`)."""
        if x.dtype == torch.uint8:
            # frames upload as raw uint8 (1/4 of the f32 bytes) and
            # normalize on the device through the host's own quotients:
            # x / 255 by multiplication with a rounded reciprocal (as
            # torch's CUDA division by a scalar computes it) differs from
            # the host's division by one ulp for half of the 256 values
            x = self._u8_unit[x.int()]
        r = self._fwd(self.forward_params if params is None else params, x)
        # a Gaussian head's sigmas stay behind: the triple is the same
        # for every head kind
        boxes, obj, cls, _uc = self._decode([h.float() for h in r["heads"]],
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
        probs = torch.where(probs > thresh, probs, torch.zeros_like(probs))
        if nms > 0:
            probs = nmslib.nms_device(tb, probs, nms, kind=self._nms_kind,
                                      beta=self._nms_beta)
        return tb, ov, probs

    def submit_detect_device(self, images, thresh: float = 0.25,
                             nms: float = 0.45, top_k: int = 256,
                             score_dtype=None):
        """Run the serving program and return its device triple
        (boxes, objectness, probs) without copying it to the host.  A
        torch tensor already on the device passes through with a shape
        check; a uint8 array uploads as uint8.  A network without a
        [yolo] or [Gaussian_yolo] head has nothing to decode here and
        raises ValueError before any work."""
        self._require_decoded_head()
        if isinstance(images, torch.Tensor):
            x = images if images.dim() == 4 else images[None]
            x = x.to(self.device)
        elif getattr(images, "dtype", None) == np.uint8:
            x = np.asarray(images)
            x = torch.from_numpy(x if x.ndim == 4 else x[None]).to(
                self.device)
        else:
            x = torch.from_numpy(self._prep_input(images)).to(self.device)
        self._check_shape(x)
        with torch.inference_mode():
            return self._serve(x, thresh, nms, top_k, score_dtype)

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
                            nms: float = 0.45, top_k: int = 256) -> list:
        return self.device_out_to_dets(
            *self.submit_detect_device(images, thresh=thresh, nms=nms,
                                       top_k=top_k))


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
