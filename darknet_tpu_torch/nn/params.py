"""Parameters: the numpy init, BN fold and int8 quantization of
`darknet_tpu/nn/params.py`, the int8 calibration probe, and the bridge
that hands those numpy arrays to torch.

`init_params`, `fuse_conv_batchnorm`, `quantize_conv_params` and
`apply_conv_input_scales` give byte-identical arrays to the JAX
package's for the same inputs (they cannot be imported from there:
`darknet_tpu/nn/__init__.py` pulls in jax).  Params are a list with
one dict per layer:

* convolutional: {"w": (kh,kw,c/g,n) HWIO, "b": (n,)} plus
  {"scales","mean","var"} when batch-normalized, and after quantization
  {"w_q": int8 HWIO, "w_scale": (n,)} and optionally "x_scale";
* connected: {"w": (inputs, outputs), "b"} (+ BN), batchnorm: {"b",
  "scales", "mean", "var"}, local: {"w": (locations, n, size*size*c),
  "b": (outputs,)}, as in the JAX package;
* every other layer: {}.

`train_params_to_torch` / `train_params_to_numpy` carry the unfolded
params to torch leaf tensors for training and back.
"""

from __future__ import annotations

import numpy as np
import torch


def init_params(graph, seed: int = 0) -> list:
    """He-style uniform conv init sqrt(2/(k*k*c/g)) * U(-1,1), connected
    U(-1,1)/sqrt(inputs), BN scales 1 and rolling stats (0, 1)."""
    rng = np.random.default_rng(seed)
    params: list[dict] = []
    for l in graph.layers:
        p: dict = {}
        if l.kind == "convolutional":
            if l.share_index is not None:
                params.append(p)
                continue
            cg = l.c // l.groups
            scale = np.sqrt(2.0 / (l.size * l.size * cg))
            if l.activation.startswith("normalize_channels"):
                w = np.ones((l.size, l.size, cg, l.n), dtype=np.float32)
            else:
                w = (scale * rng.uniform(-1, 1,
                     (l.size, l.size, cg, l.n))).astype(np.float32)
            p["w"] = w
            p["b"] = np.zeros(l.n, dtype=np.float32)
            if l.batch_normalize:
                _bn_init(p, l.n)
        elif l.kind == "connected":
            scale = 1.0 / np.sqrt(l.inputs)
            p["w"] = (scale * rng.uniform(
                -1, 1, (l.inputs, l.outputs))).astype(np.float32)
            p["b"] = np.zeros(l.outputs, dtype=np.float32)
            if l.batch_normalize:
                _bn_init(p, l.outputs)
        elif l.kind == "batchnorm":
            p["b"] = np.zeros(l.c, dtype=np.float32)
            _bn_init(p, l.c)
        elif l.kind == "local":
            locations = l.out_w * l.out_h
            scale = 1.0 / np.sqrt(l.size * l.size * l.c)
            p["w"] = (scale * rng.uniform(
                -1, 1, (locations, l.n, l.size * l.size * l.c))
            ).astype(np.float32)
            p["b"] = np.zeros(l.outputs, dtype=np.float32)
        params.append(p)
    return params


def _bn_init(p: dict, n: int) -> None:
    p["scales"] = np.ones(n, dtype=np.float32)
    p["mean"] = np.zeros(n, dtype=np.float32)
    p["var"] = np.ones(n, dtype=np.float32)


def fuse_conv_batchnorm(graph, params: list) -> list:
    """FuseConvBatchNorm (network.cpp:647-682): w *= s/std,
    b = b - s*mean/std with std = sqrt(var + 1e-5), in numpy."""
    out = []
    for l, p in zip(graph.layers, params):
        if (l.kind == "convolutional" and l.batch_normalize
                and l.share_index is None and "scales" in p):
            w = np.asarray(p["w"], dtype=np.float32)
            b = np.asarray(p["b"], dtype=np.float32)
            scales = np.asarray(p["scales"], dtype=np.float32)
            mean = np.asarray(p["mean"], dtype=np.float32)
            var = np.asarray(p["var"], dtype=np.float32)
            std = np.sqrt(var + 1e-5)
            out.append({"w": w * (scales / std)[None, None, None, :],
                        "b": b - scales * mean / std})
        else:
            out.append(dict(p))
    return out


def quantize_conv_params(graph, params: list, *, min_ch: int = 128,
                         skip_heads: bool = True, only=None) -> list:
    """Add int8 weights to eligible convs for the quantized inference path
    (ops/conv.conv_block_int8): per-output-channel symmetric absmax
    scales, "w_q" int8 HWIO and "w_scale" (n,) f32.

    Call AFTER fuse_conv_batchnorm.  Eligible: groups==1, dilation==1, no
    weight sharing, min(c, n) >= min_ch, and (when skip_heads) not a
    conv feeding a detection head.  `only` (a set of layer indices)
    quantizes those convs instead, whatever their width: the region convs
    of region_int8 (`Network.calibrate_int8`), by the same per-filter
    rule over the layer's own HWIO weights."""
    head_inputs = set()
    if skip_heads:
        for l in graph.layers:
            if l.kind in ("yolo", "gaussian_yolo", "detection"):
                head_inputs.add(l.index - 1)
    out = []
    for l, p in zip(graph.layers, params):
        p = dict(p)
        if (l.kind == "convolutional" and l.groups == 1 and l.dilation == 1
                and l.share_index is None and "w" in p
                and (l.index in only if only is not None
                     else min(l.c, l.n) >= min_ch
                     and l.index not in head_inputs)):
            w = np.asarray(p["w"], dtype=np.float32)
            absmax = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0),
                                1e-8)
            scale = (absmax / 127.0).astype(np.float32)
            p["w_q"] = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            p["w_scale"] = scale
        out.append(p)
    return out


def calibrate_conv_input_scales(graph, params: list, batches, *,
                                compute_dtype=None, device=None) -> dict:
    """Static int8 activation calibration: run the port's probe forward
    (regions and the stem fold off, so every conv is observed) over
    `batches` (iterable of (B,H,W,C) arrays) and return {layer_index:
    max |input|}, aggregated by max.  `params` are the port's torch
    params (quantized or not); the batches go to their device."""
    from darknet_tpu_torch.nn.emit import make_forward

    if device is None:
        device = next((t.device for p in params for t in p.values()
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
    fwd = make_forward(graph, compute_dtype=compute_dtype,
                       probe_conv_absmax=True)
    agg: dict[int, float] = {}
    with torch.inference_mode():
        for x in batches:
            r = fwd(params, torch.from_numpy(
                np.asarray(x, dtype=np.float32)).to(device))
            for i, v in r["conv_in_absmax"].items():
                agg[i] = max(agg.get(i, 0.0), float(v))
    return agg


def apply_conv_input_scales(params: list, absmax: dict,
                            graph=None, extra=()) -> list:
    """Attach static activation scales: p["x_scale"] = absmax/127 on every
    quantized conv (one with "w_q") whose index has a calibration entry,
    as a numpy float32 (`x_scale_to_torch` moves it to a device).

    Pass `graph` when the net uses share_index weight sharing: a sharing
    call site reads the SOURCE layer's param dict, so its input range is
    folded into the source's scale (max over all call sites).  `extra`
    lists layer indices that get an "x_scale" even without "w_q"."""
    absmax = dict(absmax)
    if graph is not None:
        for l in graph.layers:
            if (getattr(l, "kind", None) == "convolutional"
                    and getattr(l, "share_index", None) is not None
                    and l.index in absmax):
                src = l.share_index
                absmax[src] = max(absmax.get(src, 0.0),
                                  float(absmax[l.index]))
    extra = set(extra)
    out = []
    for i, p in enumerate(params):
        if ("w_q" in p or i in extra) and i in absmax:
            p = dict(p)
            p["x_scale"] = np.float32(max(float(absmax[i]), 1e-8) / 127.0)
        out.append(p)
    return out


def x_scale_to_torch(params: list, device) -> list:
    """Each numpy "x_scale" as a 1-element float32 tensor on `device`:
    the int8 kernel reads it through a pointer, with no host sync."""
    out = []
    for p in params:
        if "x_scale" in p and not isinstance(p["x_scale"], torch.Tensor):
            p = dict(p)
            p["x_scale"] = torch.tensor(
                [np.float32(p["x_scale"])], dtype=torch.float32,
                device=device)
        out.append(p)
    return out


def int8_weights_to_torch(p: dict, device) -> dict:
    """A quantized conv's "w_q" as int8 (n, kh*kw*c), K ordered (kh, kw,
    c), and its "w_scale" (n,) f32, on `device`."""
    w_q = np.asarray(p["w_q"], np.int8)
    return {"w_q": torch.from_numpy(np.ascontiguousarray(
                w_q.reshape(-1, w_q.shape[-1]).T)).to(device),
            "w_scale": torch.from_numpy(
                np.asarray(p["w_scale"], np.float32).copy()).to(device)}


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises
    (the port's entry points default to the card and never fall back to
    the CPU unless the caller names it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the port runs on the card unless the caller "
            "passes device=\"cpu\"")
    return device


TRAINABLE = ("w", "b", "scales")
# the layer kinds that carry params
PARAM_KINDS = ("convolutional", "connected", "local", "batchnorm")


def _is_conv_w(l, k) -> bool:
    return l.kind == "convolutional" and k == "w"


def train_params_to_torch(graph, np_params: list, device="cuda") -> list:
    """Unfolded numpy params (`init_params` or `weights/io.load_weights`:
    "w", "b", "scales", "mean", "var") -> float32 leaf tensors on `device`
    for training, copied: conv weights turn from HWIO into OIHW
    (channels_last), connected "w" (inputs, outputs) and local "w"
    (locations, n, size*size*c) keep the JAX package's layouts; "w", "b"
    and "scales" require grad, the rolling "mean"/"var" do not."""
    out = numpy_to_train_layout(
        graph, [p if l.kind in PARAM_KINDS else {}
                for l, p in zip(graph.layers, np_params)],
        resolve_device(device))
    for q in out:
        for k, t in q.items():
            t.requires_grad_(k in TRAINABLE)
    return out


def train_params_to_numpy(graph, params: list) -> list:
    """The inverse of `train_params_to_torch` for any list of dicts shaped
    like the params (the params themselves, or optimizer slots): float32
    numpy copies, conv weights back in HWIO, for `weights/io.save_weights`,
    checkpoints and comparison with the JAX package."""
    out = []
    for l, p in zip(graph.layers, params):
        q = {}
        for k, v in p.items():
            a = v.detach().float().cpu().numpy()
            q[k] = np.array(np.transpose(a, (2, 3, 1, 0))
                            if _is_conv_w(l, k) else a)
        out.append(q)
    return out


def numpy_to_train_layout(graph, np_dicts: list, device) -> list:
    """HWIO numpy dicts shaped like the params (the params, or optimizer
    slots from a checkpoint) -> float32 tensor copies in the training
    layout on `device`."""
    out = []
    for l, p in zip(graph.layers, np_dicts):
        q = {}
        for k, v in p.items():
            a = np.asarray(v, np.float32)
            if _is_conv_w(l, k):
                a = np.transpose(a, (3, 2, 0, 1))
            t = torch.tensor(a, device=device)
            q[k] = (t.contiguous(memory_format=torch.channels_last)
                    if _is_conv_w(l, k) else t)
        out.append(q)
    return out


def params_to_torch(graph, np_params: list, device="cuda",
                    dtype=torch.float32) -> list:
    """Numpy params (BN folded, or unfolded for `make_forward(fused_bn=
    False)`) -> the port's torch params on `device` (the card unless the
    caller names the CPU).

    Conv weights turn from HWIO into OIHW, rounded to `dtype` (the compute
    dtype) and stored channels_last as cuDNN prefers; biases stay float32.
    A bf16 network keeps its rounded weights in float32, once: the plain
    bf16 conv sums their exact products in f32 (`ops/conv.conv2d_raw`),
    and the region kernel's bf16 copy (`ops/fused_region.step_weights`)
    is exact.  Unfolded BN's "scales", "mean" and "var" stay float32.  A
    quantized conv also carries "w_q"
    as int8 (n, kh*kw*c), K ordered (kh, kw, c) (HWIO `reshape(-1, n).T`:
    both operands of the int8 GEMM K-contiguous), "w_scale" (n,) f32 and,
    when calibrated, "x_scale" (1,) f32; the float "w" stays (a region
    step without "x_scale" runs in floating point).  Connected, local and
    [batchnorm] params go over as float32 in the JAX package's layouts,
    unrounded (the connected product rounds its operands in bf16, the
    local product runs in f32; `ops/conv.connected_block`,
    `nn/emit.local_block`)."""
    device = resolve_device(device)
    out = []
    for l, p in zip(graph.layers, np_params):
        q = {}
        if l.kind == "convolutional" and "w" in p:
            w = torch.from_numpy(np.ascontiguousarray(
                np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
            w = w.to(device=device, dtype=dtype)
            if dtype == torch.bfloat16:
                w = w.float()
            q["w"] = w.contiguous(memory_format=torch.channels_last)
            for k in ("b", "scales", "mean", "var"):
                if k in p:
                    q[k] = torch.from_numpy(
                        np.asarray(p[k], np.float32).copy()).to(device)
            if "w_q" in p:
                q.update(int8_weights_to_torch(p, device))
            if "x_scale" in p:
                q["x_scale"] = p["x_scale"]
        elif l.kind in PARAM_KINDS:
            q = {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(
                device) for k, v in p.items()}
        out.append(q)
    return x_scale_to_torch(out, device)
