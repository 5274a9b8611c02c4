"""darknet_tpu_torch on a CUDA card: the region kernel and the int8 GEMM
against their plain versions, and the serving paths (f32 and int8) on the
card against the CPU.  Every test here skips without a card.  This file
imports no jax; where only torch is installed, skip tests/conftest.py
(which sets jax up):
    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: f32 kernel at 1e-4 of the output's scale (FFMA sums in
another order than cuDNN, TF32 off); bf16 at one bf16 ulp of the scale,
2^-7 (the kernel and the plain version each round a conv's f32 sum
once, in another order).  Served boxes on the
card against the CPU as in tests/test_torch_slice.py: centres within
1e-5, sizes at rtol 1e-4, objectness within 1e-5, kept sets equal once
each card slot is matched to the CPU slot of its candidate.  The int8
GEMM and the implicit-GEMM int8 conv equal their plain versions bitwise
(exact int32 sums, the same rounded epilogue).  int8 serving: the chain of quantized convs amplifies sub-ulp
differences between devices (tests/test_torch_int8.py), so each card
conv is held to the CPU's on the card's own input (rtol 1e-6, the mish
tolerance), and the card's served kept set to the CPU serving program's
on the card's heads.  uint8 frames divided on the card serve exactly
what their host-divided f32 copy serves.  Validation of a lively f32
yolov4 at 64 px: the kernel path's MapResult equals the plain path's.
Training: two f32 steps (accum 2) of chip_smoke.py's
narrow CSP + SPP graph on the card against the CPU (updates and rolling
statistics within 1e-4 of the largest change after one step, 2e-3
after two), and DetectorTrainer on its card defaults (bf16, act16).
region_int8 at 128 px: 107 int8 launches a request, none of the region
kernel, each bitwise equal to the plain version, and the triple equal to
the plain path's.  The debug modes leave a request's triple unchanged,
bitwise, and name the layer of a planted NaN in serving and in a step.
A bf16 step from a bf16 batch uploaded through the pinned staging
buffers equals the step from the f32 batch, bitwise (deterministic
cuDNN), at half the bytes.
Gaussian YOLOv3 at 64 px (f32, TF32 off): one region launch a request,
the reference-order decode (boxes, objectness, scaled class scores and
the sigmas) on the card within rtol 1e-4 / atol 1e-5 of the CPU's and
the served kept set equal once slots are matched; a network resized
from 64 to 96 px launches the kernel once on the 96 plan and serves
bitwise what a network built at 96 serves.  YOLOv1 and the rare kinds
(chip_smoke.py's NARROW_V1_CFG, RARE_KINDS_CFG, RARE_COST_CFG): the
narrow YOLOv1's heads and decode within 1e-5 of the CPU's (2e-5 for the
decode's squared sizes), its steps as the narrow CSP graph's; the rare
cfgs through the region kernel within 1e-4 of the CPU's; the quantized
antialiased conv's int8 launch bitwise equal to its plain version.
The serving artifact (`Network.export_serving`) of a lively yolov4 at
64 px, bf16 and calibrated int8, exported, saved and loaded on the card:
one region launch a request (and the int8 launches of the quantized
convs), the triple bitwise equal to `submit_detect_device`'s.
"""

import warnings

import numpy as np
import pytest
import torch

from darknet_tpu_torch import Network, model_zoo
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.nn import emit as temit
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import fused_region as tfr
from darknet_tpu_torch.ops import quant_matmul as tqm
from darknet_tpu_torch.ops.cuda import fused_region as cfr
# by file, not as tests.torch_params: an installed package named `tests`
# would shadow this directory
from torch_params import (chip_smoke, lively_params, match_slots, matched,
                          spread_params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _yolov4_prefix(px, dtype, device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(px, px))
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=0))
    tp = tparams.params_to_torch(g, npar, device, dtype)
    sub, _k = tfr.hybrid_prefix(tfr.plan_graph_regions(g, stem=True)[0])
    return sub, tp


@pytest.mark.cuda
@pytest.mark.parametrize("px", [64, 160])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_kernel(px, dtype, cuda):
    dt = getattr(torch, dtype)
    sub, tp = _yolov4_prefix(px, dt, cuda)
    x = torch.from_numpy(np.random.default_rng(px).uniform(
        0, 1, (2, px, px, 3)).astype(np.float32)).to(cuda)
    ws, bs = tfr.step_weights(sub.steps, tp, dt)
    want = tfr.region_plain(sub, x, ws, bs, compute_dtype=dt).float()
    before = cfr.launches
    got = cfr.region_call(sub, x, ws, bs, compute_dtype=dt).float()
    torch.cuda.synchronize()
    assert cfr.launches == before + 1
    tol = 1e-4 if dt == torch.float32 else 2.0 ** -7
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _region_case(case):
    """(graph, batch, region start) of a tensor-core kernel case."""
    smoke = chip_smoke()
    if case == "narrow-csp":
        cfg, b, a = smoke.NARROW_CSP_CFG, 2, 0
    elif case == "wide":
        cfg, b, a = smoke.conv_stack_cfg(64, smoke.WIDE_LAYERS), 2, 1
    elif case.startswith("yolov4-tiny"):
        cfg, b = model_zoo.yolov4_tiny_cfg(416, 416), 1
        a = int(case.rsplit("region", 1)[1])
    else:
        px = int(case.split("-")[1])
        cfg, b, a = model_zoo.yolov4_cfg(px, px), 2 if px == 608 else 1, 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_graph(cfg), b, a


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["yolov4-608", "yolov4-416", "narrow-csp",
                                  "yolov4-tiny-416-region4",
                                  "yolov4-tiny-416-region12", "wide"])
def test_region_tc_kernel(case, cuda):
    """The bf16 tensor-core kernel against its plain version: yolov4's
    prefix at 608 (b=2) and 416 (b=1); a narrow CSP region (8-channel
    slots zero-padded to 16, a route concat) whose last tile is ragged;
    yolov4-tiny's two regions, which have no stem (their inputs are 32 and
    64 channels, loaded element by element); and a region whose
    1024-channel step fits only with narrowed weight passes.  One bf16
    ulp of the output's scale."""
    g, b, a = _region_case(case)
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=3))
    tp = tparams.params_to_torch(g, npar, cuda, torch.bfloat16)
    plan = tfr.plan_graph_regions(g, stem=True)[a]
    sub = (tfr.hybrid_prefix(plan) or (plan,))[0]
    kp = cfr.kernel_plan(sub, 2)
    if case == "narrow-csp":
        assert sub.h % kp.tile or (2 * sub.w2) % kp.tile      # ragged
        assert min(c for st in sub.conv_steps for c in st.srcs_c) == 8
        assert any(len(st.srcs) > 1 for st in sub.conv_steps)
    if case == "wide":            # the passes mma_config prefers do not fit
        assert cfr._tc_plan(sub, kp.tile, cfr.TC_THREADS,
                            cfr._slot_ids(sub))[0] > cfr.SMEM_MAX
    rng = np.random.default_rng(1)
    if sub.stem:
        x = rng.uniform(0, 1, (b, g.net.h, g.net.w, 3))
    else:
        x = rng.normal(0, 1, (b, sub.h, 2 * sub.w2, sub.in_c))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    assert sub.stem == (case in ("yolov4-608", "yolov4-416", "narrow-csp"))
    ws, bs = tfr.step_weights(sub.steps, tp, torch.bfloat16)
    want = tfr.region_plain(sub, x, ws, bs,
                            compute_dtype=torch.bfloat16).float()
    got = cfr.region_call(sub, x, ws, bs,
                          compute_dtype=torch.bfloat16).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 2.0 ** -7 * float(
        want.abs().max())


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_bf16_request_runs_tensor_core_kernel(cuda):
    """A bf16 request launches the tensor-core region kernel, an f32
    request the FFMA kernel: the wrapper's count of each kernel, exactly,
    and over three profiled requests the right kernel's name in the
    torch.profiler trace and never the other's (a trace may drop an event
    now and then, so the count is what is exact)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(64, 64))
    npar = tparams.fuse_conv_batchnorm(g, tparams.init_params(g, seed=0))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    for dt, name, other in ((torch.bfloat16, "region_tc_kernel",
                             "region_kernel"),
                            (torch.float32, "region_kernel",
                             "region_tc_kernel")):
        net = Network(g, tparams.params_to_torch(g, npar, cuda, dt),
                      device=cuda, compute_dtype=dt)
        net.submit_detect_device(x)                 # build, plan, warm up
        before, total = dict(cfr.variant_launches), cfr.launches
        names = _device_kernels(
            lambda: [net.submit_detect_device(x) for _ in range(3)])
        assert cfr.launches == total + 3
        assert cfr.variant_launches[name] == before[name] + 3
        assert cfr.variant_launches[other] == before[other]
        assert any(name in n for n in names)
        assert not any(other in n for n in names)


def _lively_nets(px):
    """The same lively f32 yolov4 on the card and on the CPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(px, px))
    npar = tparams.fuse_conv_batchnorm(g, lively_params(g))
    return [Network(g, tparams.params_to_torch(g, npar, dev, torch.float32),
                    device=dev) for dev in ("cuda", "cpu")]


def _kept(probs):
    return set(zip(*np.nonzero(np.asarray(probs) > 0)))


@pytest.mark.cuda
def test_forward_on_card_matches_cpu(cuda):
    """The whole yolov4 forward (kernel region prefix on the card, plain
    version on the CPU), f32 with TF32 off."""
    gpu, cpu = _lively_nets(64)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    before = cfr.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        a = gpu._fwd(gpu.params, torch.from_numpy(x).to(cuda))
        b = cpu._fwd(cpu.params, torch.from_numpy(x))
    assert cfr.launches == before + 1
    for u, v in zip(a["raw_heads"], b["raw_heads"]):
        scale = float(v.abs().max())
        assert float((u.cpu() - v).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("thresh,nms", [(0.25, 0.45), (0.1, 0.3)])
def test_serving_on_card_matches_cpu(thresh, nms, cuda):
    """The serving program (decode, stable top-k, device NMS) on the card
    keeps what it keeps on the CPU."""
    gpu, cpu = _lively_nets(64)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    before = cfr.launches
    tb, ov, probs = gpu.submit_detect_device(x, thresh=thresh, nms=nms)
    assert cfr.launches == before + 1 and tb.is_cuda
    ctb, cov, cprobs = cpu.submit_detect_device(x, thresh=thresh, nms=nms)
    a = tb.cpu().numpy()
    slot = match_slots(a, ctb.numpy())
    b, cv, cp = matched((ctb, cov, cprobs), slot)
    kept = _kept(cp)
    assert len(kept) > 5
    assert _kept(probs.cpu()) == kept
    np.testing.assert_allclose(a[..., :2], b[..., :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a[..., 2:], b[..., 2:], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ov.cpu().numpy(), cv, atol=1e-5)
    dets = Network.device_out_to_dets(tb, ov, probs)
    assert [len(d) for d in dets] == [
        len(d) for d in Network.device_out_to_dets(ctb, cov, cprobs)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uint8_ingest_equals_host_division(dtype, cuda):
    """uint8 frames divided by 255 on the card and their f32 copy divided
    on the host are the same input (both correctly rounded f32
    divisions): the served triples are equal, bitwise."""
    dt = getattr(torch, dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(64, 64))
    net = Network(g, tparams.params_to_torch(
        g, tparams.fuse_conv_batchnorm(g, lively_params(g)), cuda, dt),
        compute_dtype=dt, device=cuda)
    frames = (np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3))
              * 255).astype(np.uint8)
    a = net.submit_detect_device(frames, thresh=0.25)
    b = net.submit_detect_device(frames.astype(np.float32) / 255,
                                 thresh=0.25)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_validate_detector_kernel_matches_plain(cuda, tmp_path):
    """validate_detector of a lively f32 yolov4 at 64 px on a synth set:
    one region launch a batch, and the kernel path's MapResult equals the
    plain path's."""
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.eval.map import validate_detector

    # the set and weights of tests/test_torch_eval.py's exact parity
    files = synth.generate(str(tmp_path), n_train=0, n_val=6, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(64, 64, classes=4))
    tp = tparams.params_to_torch(
        g, tparams.fuse_conv_batchnorm(g, lively_params(g)), cuda)
    res = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name in ("kernel", "plain"):
            net = Network(g, tp, device=cuda, fuse_regions=(
                "hybrid" if name == "kernel" else "plain"))
            before = cfr.launches
            res[name] = validate_detector(net, files["val_paths"], 4,
                                          batch=4, progress=False,
                                          resize="darknet")
            res[name + "_launches"] = cfr.launches - before
    assert res["kernel_launches"] == 2 and res["plain_launches"] == 0
    a, b = res["kernel"], res["plain"]
    assert a.n_gt == b.n_gt > 0 and a.n_pred == b.n_pred > 0
    assert a.map == b.map
    np.testing.assert_array_equal(a.per_class_ap, b.per_class_ap)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", [
    (1000, 96, 200, 0), (37, 50, 9, 0), (300, 128, 70, 1),
    (8 * 19 * 19, 9 * 512, 1024, 0), (8 * 76 * 76, 256, 256, 0)])
def test_int8_gemm_kernel(m, k, n, offset, cuda):
    """Ragged M, N and K (a K % 16 != 0 is zero-padded and a misaligned
    operand copied before the TMA loads) and yolov4-608 shapes at b=8:
    bitwise equal."""
    rng = np.random.default_rng(m + k + n)
    buf = torch.from_numpy(rng.integers(-127, 128, m * k + offset,
                                        dtype=np.int8)).to(cuda)
    a = buf[offset:].view(m, k)
    b = torch.from_numpy(rng.integers(-127, 128, (n, k),
                                      dtype=np.int8)).to(cuda)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    xs = torch.tensor([0.0039], device=cuda)
    for leaky in (False, True):
        before = tqm.launches
        got = tqm.int8_matmul(a, b, ws.to(cuda), bias.to(cuda), xs,
                              leaky=leaky)
        want = tqm.int8_matmul_plain(a, b, ws.to(cuda), bias.to(cuda), xs,
                                     leaky=leaky)
        torch.cuda.synchronize()
        assert tqm.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,n,size,stride", [
    (8, 76, 76, 256, 256, 1, 1),         # yolov4-608 1x1 (TMA A)
    (8, 38, 38, 256, 256, 3, 1),         # 3x3/1 (gathered A)
    (8, 76, 76, 256, 512, 3, 2),         # 3x3/2
    (8, 19, 19, 1024, 512, 3, 1),        # 3x3 at 19x19, C = 1024
    (3, 13, 11, 128, 200, 3, 1),         # ragged M, N not a tile multiple
    (2, 9, 7, 48, 70, 3, 2),             # C % 128 != 0, N % 8 != 0
    (2, 10, 6, 40, 24, 1, 1),            # C % 16 != 0: padded
    (5, 17, 17, 128, 384, 1, 2),         # 1x1 stride 2: TMA im2col
    (2, 14, 9, 128, 128, 3, 2),          # non-square, stride 2
    (1, 20, 33, 256, 256, 3, 1)])        # non-square, C = 2 blocks
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_conv_kernel(b, h, w, c, n, size, stride, out_dtype, cuda):
    """The implicit-GEMM conv against its plain version (explicit im2col,
    float64 GEMM, the same epilogue, the cast): bitwise equal, with and
    without leaky."""
    dt = getattr(torch, out_dtype)
    rng = np.random.default_rng(b * h + c + n)
    pad = size // 2
    oh, ow = (h + 2 * pad - size) // stride + 1, (w + 2 * pad - size) // stride + 1
    padding = tconv.darknet_conv_padding(size, pad, 1, (h, w),
                                         (stride, stride), (oh, ow))
    x_q = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c),
                                        dtype=np.int8)).to(cuda)
    w_q = torch.from_numpy(rng.integers(-127, 128, (n, size * size * c),
                                        dtype=np.int8)).to(cuda)
    ws = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32)).to(
        cuda)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    xs = torch.tensor([0.0039], device=cuda)
    kw = dict(size=size, stride=(stride, stride), padding=padding,
              out_hw=(oh, ow), out_dtype=dt)
    for leaky in (False, True):
        before = tqm.launches
        got = tqm.int8_conv(x_q, w_q, ws, bias, xs, leaky=leaky, **kw)
        want = tqm.int8_conv_plain(x_q, w_q, ws, bias, xs, leaky=leaky, **kw)
        torch.cuda.synchronize()
        assert tqm.launches == before + 1
        assert got.dtype == dt and got.shape == (b, oh, ow, n)
        assert torch.equal(got, want)


def _int8_nets(px):
    """The same lively quantized f32 yolov4 on the card and on the CPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.yolov4_cfg(px, px))
    npar = tparams.quantize_conv_params(
        g, tparams.fuse_conv_batchnorm(g, lively_params(g)))
    return [Network(g, tparams.params_to_torch(g, npar, dev, torch.float32),
                    device=dev) for dev in ("cuda", "cpu")]


@pytest.mark.cuda
def test_int8_serving_on_card(cuda, monkeypatch, tmp_path):
    gpu, cpu = _int8_nets(64)
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    before = tqm.launches
    gpu.submit_detect_device(x)
    assert tqm.launches == before + 90           # dynamic: 23 stays float
    cpu.calibrate_int8([x])
    cpu.save_calibration(tmp_path / "scales.cache")
    gpu.load_calibration(tmp_path / "scales.cache")

    recs = []

    def record(xin, p, l, **kw):
        y = tconv.conv_block_int8(xin, p, l, **kw)
        recs.append((l.index, xin, y))
        return y

    monkeypatch.setattr(temit, "conv_block_int8", record)
    before = tqm.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        heads = gpu._fwd(gpu.params, torch.from_numpy(x).to(cuda))["heads"]
        tb, ov, probs = gpu._serve(torch.from_numpy(x).to(cuda), 0.1, 0.3,
                                   256, None)
    assert tqm.launches == before + 2 * 91 and len(recs) == 2 * 90
    for i, xin, y in recs[:90]:
        want = tconv.conv_block_int8(xin.cpu(), cpu.params[i],
                                     cpu.graph.layers[i])
        torch.testing.assert_close(y.cpu(), want, rtol=1e-6, atol=1e-6)

    cheads = [h.cpu() for h in heads]
    monkeypatch.setattr(cpu, "_fwd", lambda params, x: {"heads": cheads})
    ctb, cov, cprobs = cpu.submit_detect_device(x, thresh=0.1, nms=0.3)
    a = tb.cpu().numpy()
    slot = match_slots(a, ctb.numpy())
    b, cv, cp = matched((ctb, cov, cprobs), slot)
    kept = _kept(cp)
    assert len(kept) > 5
    assert _kept(probs.cpu()) == kept
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ov.cpu().numpy(), cv, atol=1e-5)


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(cuda):
    cs = chip_smoke()
    g = cs.quiet_graph(cs.TRAIN_CSP_CFG, train=True)
    p0 = tparams.init_params(g, seed=0)
    x, y = cs.train_batch(g, 4, seed=1)
    on_card, on_cpu = cs.train_stepper(g, cuda), cs.train_stepper(g, "cpu")
    card = cpu = cs.train_state0(g, p0)
    for tol in (1e-4, 2e-3):
        card, c_card = on_card(card, x, y)
        cpu, c_cpu = on_cpu(cpu, x, y)
        np.testing.assert_allclose(c_card, c_cpu, rtol=1e-5)
        for keys in (("w", "b", "scales"), ("mean", "var")):
            err, scale = cs.update_gap(card[0], cpu[0], p0, keys)
            assert scale > 0 and err <= tol * scale, (tol, keys, err, scale)


@pytest.mark.cuda
def test_trainer_on_card_defaults(cuda, tmp_path):
    """DetectorTrainer without device= trains on the card in bf16 with
    bf16 interlayer tensors: finite losses, the weights and the state
    saved, no kernel launched."""
    from darknet_tpu_torch.data import synth
    from darknet_tpu_torch.train.trainer import DetectorTrainer

    cs = chip_smoke()
    files = synth.generate(str(tmp_path / "data"), n_train=8, n_val=2,
                           seed=3)
    cfg = cs.TRAIN_CSP_CFG.replace("subdivisions=1", "subdivisions=2")
    losses = []
    before = cfr.launches
    tr = DetectorTrainer(cfg, files["train_paths"], classes=4,
                         save_dir=str(tmp_path / "out"), loader_processes=0,
                         log=losses.append)
    try:
        assert tr.compute_dtype == torch.bfloat16 and tr.act16
        assert tr.params[0]["w"].is_cuda
        tr.train(max_iters=2)
    finally:
        tr.close()
    assert cfr.launches == before
    assert sum(line.startswith("[000") for line in losses) == 2
    assert (tmp_path / "out" / "model_final.weights").exists()
    assert (tmp_path / "out" / "model_last.ckpt.npz").exists()


def _gaussian_nets(px, path):
    """The same lively f32 Gaussian YOLOv3 (10 classes) from `path` on
    the card and on the CPU."""
    cfg = model_zoo.gaussian_yolov3_cfg(px, px, classes=10)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [Network.from_cfg(cfg, weights=path, device=dev)
                for dev in ("cuda", "cpu")]


@pytest.fixture
def gaussian_weights(tmp_path):
    from darknet_tpu_torch.weights import io as wio

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(model_zoo.gaussian_yolov3_cfg(64, 64, classes=10))
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    path = str(tmp_path / "gaussian.weights")
    wio.save_weights(g, spread_params(g, x, 1.2), path)
    return path


@pytest.mark.cuda
def test_gaussian_request_on_card_matches_cpu(cuda, gaussian_weights):
    gpu, cpu = _gaussian_nets(64, gaussian_weights)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        before = cfr.launches
        tb, _ov, probs = gpu.submit_detect_device(x, thresh=0.25)
        assert cfr.launches == before + 1 and tb.is_cuda
        _h, dec = gpu.forward_heads(x)
    ctb, cov, cprobs = cpu.submit_detect_device(x, thresh=0.25)
    _h, cdec = cpu.forward_heads(x)
    assert dec[3] is not None and dec[3].shape[-1] == 4
    for a, b in zip(dec, cdec):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    slot = match_slots(tb.cpu().numpy(), ctb.numpy())
    _b, _cv, cp = matched((ctb, cov, cprobs), slot)
    assert len(_kept(cp)) > 5 and _kept(probs.cpu()) == _kept(cp)


@pytest.mark.cuda
def test_resized_network_launches_new_plan(cuda, gaussian_weights,
                                           monkeypatch):
    gpu, _cpu = _gaussian_nets(64, gaussian_weights)
    fresh, _cpu = _gaussian_nets(96, gaussian_weights)
    resized = gpu.resize(96, 96)
    sub, _k = tfr.hybrid_prefix(resized._fwd.region_plans[0])
    seen = []
    launch = cfr.launch

    def spy(kp, *a, **k):
        seen.append((int(kp.table[3]), int(kp.table[4])))
        return launch(kp, *a, **k)

    monkeypatch.setattr(cfr, "launch", spy)
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 96, 3)).astype(
        np.float32)
    a = resized.submit_detect_device(x, thresh=0.25)
    assert seen == [(sub.h, 2 * sub.w2)] and sub.h == 48
    b = fresh.submit_detect_device(x, thresh=0.25)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _v1_nets(cfg, device, scale=1.5, **kw):
    """The folded init of `cfg` (BN scales times `scale`) as a Network on
    `device` and on the CPU."""
    cs = chip_smoke()
    g = cs.quiet_graph(cfg)
    raw = tparams.init_params(g, seed=0)
    for p in raw:
        if "scales" in p:
            p["scales"] = p["scales"] * np.float32(scale)
    npar = tparams.fuse_conv_batchnorm(g, raw)
    return [Network(g, tparams.params_to_torch(g, npar, dev), device=dev,
                    **kw) for dev in (device, "cpu")]


def _scaled(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


@pytest.mark.cuda
def test_v1_request_on_card_matches_cpu(cuda):
    """The narrow YOLOv1 in f32 (TF32 off): heads within 1e-5 of their
    scale of the CPU's, the [detection] decode on the card likewise, no
    host detections, and the device path refused."""
    from darknet_tpu_torch.ops.detection_v1 import detection_decode

    gpu, cpu = _v1_nets(chip_smoke().NARROW_V1_CFG, cuda)
    x = np.random.default_rng(0).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    h, _ = gpu.forward_heads(x)
    ch, _ = cpu.forward_heads(x)
    assert _scaled(h[0], ch[0]) <= 1e-5
    l = gpu.graph.layers[-1]
    with torch.inference_mode():
        r = gpu._fwd(gpu.params, torch.from_numpy(x).to(cuda))
    for a, b in zip(detection_decode(r["heads"][0].reshape(4, -1), l),
                    detection_decode(torch.from_numpy(ch[0]).reshape(4, -1),
                                     l)):
        assert a.is_cuda and _scaled(a.cpu(), b) <= 2e-5
    assert gpu.detect_batch(x) == [[]] * 4
    with pytest.raises(ValueError, match="detection"):
        gpu.submit_detect_device(x)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["RARE_KINDS_CFG", "RARE_COST_CFG"])
def test_rare_kinds_on_card_match_cpu(cuda, name):
    """One region launch a request (layers 1-3), the output within 1e-4 of
    its scale of the CPU's (the FFMA kernel and cuDNN sum in another
    order)."""
    gpu, cpu = _v1_nets(getattr(chip_smoke(), name), cuda)
    x = np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 3)).astype(
        np.float32)
    before = cfr.launches
    out = gpu.predict(x)
    assert cfr.launches == before + 1
    assert np.isfinite(out).all() and _scaled(out, cpu.predict(x)) <= 1e-4


@pytest.mark.cuda
def test_v1_step_on_card_matches_cpu(cuda):
    """Two f32 steps (accum 2) of the narrow YOLOv1 on the card, no
    generator, against the CPU: updates and rolling statistics within 1e-4
    of the largest change after one step, 2e-3 after two; the cost within
    1e-5 at the first step and 1e-4 at the second, which starts from
    states whose momentum differs by up to 7e-5 of its scale (a card run
    of phase 12).  A generator on the CPU is refused for the card's
    tensors; one on the card drops."""
    cs = chip_smoke()
    g = cs.quiet_graph(cs.NARROW_V1_CFG, train=True)
    p0 = tparams.init_params(g, seed=0)
    x, y = cs.train_batch(g, 4, seed=cs.V1_PARITY_SEED)
    on_card, on_cpu = cs.train_stepper(g, cuda), cs.train_stepper(g, "cpu")
    card = cpu = cs.train_state0(g, p0)
    for tol, c_tol in ((1e-4, 1e-5), (2e-3, 1e-4)):
        card, c_card = on_card(card, x, y)
        cpu, c_cpu = on_cpu(cpu, x, y)
        np.testing.assert_allclose(c_card, c_cpu, rtol=c_tol)
        for keys in (("w", "b", "scales"), ("mean", "var")):
            err, scale = cs.update_gap(card[0], cpu[0], p0, keys)
            assert scale > 0 and err <= tol * scale, (tol, keys, err, scale)
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step

    step = make_train_step(g)
    p = tparams.train_params_to_torch(g, p0, cuda)
    o = init_opt_state(g, p)
    xt, yt = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    with pytest.raises(ValueError, match="generator"):
        step(p, o, xt, yt, g.net.lr, torch.Generator().manual_seed(0))
    p = tparams.train_params_to_torch(g, p0, cuda)
    o = init_opt_state(g, p)
    _p, _o, cost, _m = step(p, o, xt[:2], yt[:2], g.net.lr,
                            torch.Generator(device=cuda).manual_seed(0))
    p = tparams.train_params_to_torch(g, p0, cuda)
    o = init_opt_state(g, p)
    _p, _o, kept, _m = step(p, o, xt[:2], yt[:2], g.net.lr)
    assert torch.isfinite(cost) and float(cost) != float(kept)


@pytest.mark.cuda
def test_rare_int8_antialiased_conv_on_card(cuda, monkeypatch):
    """The antialiased 128 -> 128 conv of RARE_KINDS_CFG quantizes: one
    int8 launch a request, bitwise equal to the plain version, then the
    blur."""
    cs = chip_smoke()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(cs.RARE_KINDS_CFG, seed=0, int8=True,
                               compute_dtype=torch.bfloat16, device=cuda)
    recs = []
    orig = tconv.int8_conv

    def spy(*a, **kw):
        y = orig(*a, **kw)
        recs.append((a, kw, y))
        return y

    monkeypatch.setattr(tconv, "int8_conv", spy)
    before = tqm.launches
    out = net.predict(np.random.default_rng(2).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32))
    assert tqm.launches == before + 1 and len(recs) == 1
    a, kw, y = recs[0]
    assert torch.equal(y, tqm.int8_conv_plain(*a, **kw))
    assert np.isfinite(out).all()


@pytest.mark.cuda
def test_region_int8_on_card(cuda, monkeypatch):
    """region_int8 on yolov4 at 128 px, b=2: 107 int8 launches a request
    and no region launch; every launch bitwise equal to the plain version
    on its operands; the triple equal to the plain path's (every int8
    conv through its plain version on the card)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(model_zoo.yolov4_cfg(128, 128), seed=0,
                               int8=True, compute_dtype=torch.bfloat16,
                               device=cuda)
    x = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    net.calibrate_int8([x[0]], region_int8=True)
    recs = []

    def record(x_q, w_q, ws, bias, xs, **kw):
        out = tqm.int8_conv(x_q, w_q, ws, bias, xs, **kw)
        recs.append(((x_q, w_q, ws, bias, xs), kw, out))
        return out

    monkeypatch.setattr(tconv, "int8_conv", record)
    q0, r0 = tqm.launches, cfr.launches
    got = net.submit_detect_device(x, thresh=0.1)
    torch.cuda.synchronize()
    assert (tqm.launches - q0, cfr.launches - r0) == (107, 0)
    assert len(recs) == 107
    for ops, kw, out in recs:
        assert torch.equal(out, tqm.int8_conv_plain(*ops, **kw))
    monkeypatch.setattr(tconv, "int8_conv", tqm.int8_conv_plain)
    want = net.submit_detect_device(x, thresh=0.1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_debug_modes_on_card(cuda):
    """debug_sync_mode and debug_nans on the card: the same triple as
    without; a NaN planted in layer 25's weights raises
    FloatingPointError naming the layer, in serving and in a training
    step of the narrow CSP graph (layer 2)."""
    from darknet_tpu_torch.utils import debug

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        net = Network.from_cfg(model_zoo.yolov4_cfg(128, 128), seed=0,
                               compute_dtype=torch.bfloat16, device=cuda)
    x = np.random.default_rng(4).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    want = net.submit_detect_device(x)
    with debug.debug_sync_mode(), debug.debug_nans():
        got = net.submit_detect_device(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    net.params = [dict(p) for p in net.params]
    w = net.params[25]["w"].clone()
    w[0, 0, 0, 0] = float("nan")
    net.params[25]["w"] = w
    with debug.debug_sync_mode(), debug.debug_nans():
        with pytest.raises(FloatingPointError, match="L025_convolutional"):
            net.submit_detect_device(x)

    from darknet_tpu_torch.train.step import init_opt_state, make_train_step

    cs = chip_smoke()
    g = cs.quiet_graph(cs.TRAIN_CSP_CFG, train=True)
    p0 = tparams.init_params(g, seed=0)
    p0[2]["w"][0, 0, 0, 0] = np.nan
    params = tparams.train_params_to_torch(g, p0, cuda)
    bx, by = cs.train_batch(g, 4, seed=1)
    step = make_train_step(g)
    with debug.debug_sync_mode(), debug.debug_nans():
        with pytest.raises(FloatingPointError, match="L002_convolutional"):
            step(params, init_opt_state(g, params), torch.from_numpy(bx).to(
                cuda), torch.from_numpy(by).to(cuda), 1e-3)


@pytest.mark.cuda
def test_pinned_bf16_upload_step_is_bitwise(cuda):
    """The narrow CSP graph's bf16 act16 step (accum 2) from the f32 batch
    and from its bf16 cast uploaded through pinned staging buffers: equal
    params and momentum, bitwise (deterministic cuDNN); the staging
    buffers are pinned and the bf16 upload is half the bytes."""
    from darknet_tpu_torch.data.loader import bf16_from_f32
    from darknet_tpu_torch.train.step import init_opt_state, make_train_step
    from darknet_tpu_torch.train.trainer import PinnedUploader

    cs = chip_smoke()
    g = cs.quiet_graph(cs.TRAIN_CSP_CFG.replace("subdivisions=1",
                                                "subdivisions=2"), train=True)
    p0 = tparams.init_params(g, seed=0)
    bx, by = cs.train_batch(g, 4, seed=1)
    step = make_train_step(g, compute_dtype=torch.bfloat16, accum=2,
                           train_act_dtype=torch.bfloat16)
    out, sent = [], []
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for batch in (bx, bf16_from_f32(bx)):
            ux, uy = PinnedUploader(cuda), PinnedUploader(cuda)
            xt, yt = ux(batch), uy(by)
            assert ux._slots[0][0].is_pinned() and xt.dtype == (
                torch.float32 if isinstance(batch, np.ndarray)
                else torch.bfloat16)
            sent.append(ux.bytes)
            params = tparams.train_params_to_torch(g, p0, cuda)
            opt = init_opt_state(g, params)
            params, opt, cost, _m = step(params, opt, xt, yt, 1e-3)
            out.append((params, opt["u"], float(cost)))
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1])
    (pa, ua, ca), (pb, ub, cb) = out
    assert ca == cb
    for a, b in zip(pa + ua, pb + ub):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert sent[1] * 2 == sent[0] == bx.nbytes


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_export_round_trip_on_card(int8, cuda, tmp_path):
    """export_serving on the card: the loaded program launches the region
    kernel once a request, and the int8 GEMM once a quantized conv, and
    returns submit_detect_device's triple bitwise."""
    from darknet_tpu_torch.nn import network as tnetwork
    from darknet_tpu_torch.weights import io as wio

    cfg = model_zoo.yolov4_cfg(64, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
        path = str(tmp_path / "w.weights")
        wio.save_weights(g, lively_params(g), path)
        net = Network.from_cfg(cfg, weights=path, int8=int8,
                               compute_dtype=torch.bfloat16)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    if int8:
        net.calibrate_int8(x)
    n_q = sum("w_q" in p for p in net.params) if int8 else 0
    live = net.submit_detect_device(x, thresh=0.1)
    art = str(tmp_path / "serve.pt2")
    net.export_serving(art, batch=2, thresh=0.1)
    tnetwork._loaded.clear()
    Network.run_exported_serving(art, x)                # load, build
    torch.cuda.synchronize()
    r0, q0 = cfr.launches, tqm.launches
    got = Network.run_exported_serving(art, x)
    torch.cuda.synchronize()
    assert (cfr.launches - r0, tqm.launches - q0) == (1, n_q)
    assert all(t.is_cuda for t in got)
    for a, b in zip(live, got):
        assert torch.equal(a, b)
