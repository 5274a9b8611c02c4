"""The one-pass epilogue of a bf16 conv (`ops/cuda/conv_epilogue.py`,
`conv_epilogue_kernel` of `csrc/fused_region.cu`) and the int8 GEMM's own
leaky epilogue on the served path.

On the CPU:
- the op `darknet_tpu_torch::conv_epilogue` (its plain version) is
  bitwise the previous epilogue of `ops/conv.conv2d_raw` (the f32 bias
  added in place on the NCHW view, one cast to bf16) followed by
  `apply_activation`, for every activation with a kernel code, at 255
  and 57 channels (ragged) and 64;
- `conv_block` on a CPU tensor is bitwise the previous code, in bf16
  and f32; the routing takes the kernel only for a bf16 conv on the card
  whose activation has a code;
- `torch.export` records the op as one node and the exported program
  computes what the op does.

On a card (`-m cuda`, skips here):
- at every conv yolov4-608 serves outside its region kernel at b=8 (the
  benchmark cell's weights and frames), on the conv's own f32 sum, the
  kernel equals the plain version bitwise for linear, leaky, relu and
  logistic, and within one bf16 ulp for mish, swish, tanh and gelu
  (nvcc contracts mish's `q - 1` and gelu's polynomial into FMAs); the
  share of elements that differ is printed;
- every such sum reaches the op NHWC-contiguous (no copy in the wrapper);
- a served request launches the kernel once per conv it serves outside
  the region kernel (the region remainder's steps included);
- ragged shapes (C of 255 and 57, n % 8 != 0) against the plain version;
- the int8 convs of the Gaussian YOLOv3 cell, leaky in the GEMM's
  epilogue, equal the previous `int8_conv` then `apply_activation`
  bitwise, with bf16 and f32 outputs.

This file imports no jax.  On the card:
    python -m pytest --noconftest -s -m cuda tests/test_torch_conv_epilogue.py
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from darknet_tpu_torch.nn import emit as temit
from darknet_tpu_torch.ops import conv as tconv
from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)
from darknet_tpu_torch.ops.activations import apply_activation
from darknet_tpu_torch.ops.cuda import conv_epilogue as ce
from darknet_tpu_torch.ops.cuda.fused_region import ACT_CODES
from darknet_tpu_torch.utils import spans
# by file, not as tests.torch_params: an installed package named `tests`
# would shadow this directory
from torch_params import cell_net

BITWISE = ("linear", "leaky", "relu", "logistic")
ONE_ULP = ("mish", "swish", "tanh", "gelu")


def _previous(y_nhwc, b, act):
    """The epilogue before the kernel: `conv2d_raw`'s in-place f32 bias
    add on the NCHW view and one cast, then `apply_activation`."""
    y = y_nhwc.permute(0, 3, 1, 2).clone()
    y.add_(b.float().view(-1, 1, 1))
    return apply_activation(y.to(torch.bfloat16).permute(0, 2, 3, 1), act)


def _sum_and_bias(c, seed, shape=(2, 5, 7)):
    """An f32 conv sum whose values cross every activation's kinks and
    mish's +-20 thresholds, and a bias."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 8, size=(*shape, c)).astype(np.float32)
    y.reshape(-1)[::11] *= 4
    b = rng.normal(0, 2, size=c).astype(np.float32)
    return torch.from_numpy(y), torch.from_numpy(b)


@pytest.mark.parametrize("c", [255, 57, 64])
@pytest.mark.parametrize("act", sorted(ACT_CODES))
def test_plain_is_the_previous_epilogue(act, c):
    y, b = _sum_and_bias(c, seed=c + ACT_CODES[act])
    got = torch.ops.darknet_tpu_torch.conv_epilogue(y, b, act)
    assert got.dtype == torch.bfloat16 and got.shape == y.shape
    want = _previous(y, b, act)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), act


def _layer(act, c_in=6, n=57, hw=(9, 11), size=3, stride=1, bn=1):
    h, w = hw
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    return types.SimpleNamespace(
        size=size, pad=1, dilation=1, h=h, w=w, c=c_in, stride_y=stride,
        stride_x=stride, out_h=oh, out_w=ow, n=n, groups=1,
        batch_normalize=bn, activation=act, antialiasing=0)


def _previous_conv_block(x, p, l, compute_dtype):
    """`conv_block`'s folded branch before the kernel."""
    padding = tconv.darknet_conv_padding(
        l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
        (l.out_h, l.out_w))
    y = tconv.conv2d_raw(x, p["w"], p["b"], stride=(l.stride_y, l.stride_x),
                         padding=padding, dilation=(1, 1), groups=1,
                         compute_dtype=compute_dtype)
    return apply_activation(y, l.activation)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("act,stride", [("mish", 1), ("leaky", 2),
                                        ("linear", 1), ("selu", 1)])
def test_conv_block_on_the_cpu_is_unchanged(act, stride, dtype):
    dt = getattr(torch, dtype)
    l = _layer(act, stride=stride)
    rng = np.random.default_rng(stride)
    x = torch.from_numpy(rng.normal(size=(2, l.h, l.w, l.c)).astype(
        np.float32)).to(dt)
    w = torch.from_numpy(rng.normal(0, .5, size=(l.n, l.c, 3, 3)).astype(
        np.float32)).to(dt).float()
    p = {"w": w.contiguous(memory_format=torch.channels_last),
         "b": torch.from_numpy(rng.normal(size=l.n).astype(np.float32))}
    before = ce.launches
    got = tconv.conv_block(x, p, l, compute_dtype=dt)
    want = _previous_conv_block(x, p, l, dt)
    assert ce.launches == before
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_one_pass_routing():
    """The kernel serves a folded bf16 conv on the card whose activation
    has a code; f32, the CPU and other activations keep the previous
    path."""
    card, cpu = (types.SimpleNamespace(is_cuda=v) for v in (True, False))
    bf16 = torch.bfloat16
    for act in ACT_CODES:
        assert tconv.kernel_epilogue(card, act, bf16)
        assert not tconv.kernel_epilogue(cpu, act, bf16)
        assert not tconv.kernel_epilogue(card, act, torch.float32)
        assert not tconv.kernel_epilogue(card, act, None)
    for act in ("selu", "elu", "normalize_channels", "zero"):
        assert not tconv.kernel_epilogue(card, act, bf16)


def test_export_records_the_op(tmp_path):
    class Epi(torch.nn.Module):
        def forward(self, y, b):
            return ce.conv_epilogue(y, b, "mish")

    y, b = _sum_and_bias(57, seed=3)
    prog = torch.export.export(Epi(), (y, b))
    targets = [str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"]
    assert targets == ["darknet_tpu_torch.conv_epilogue.default"], targets
    path = str(tmp_path / "epi.pt2")
    torch.export.save(prog, path)
    got = torch.export.load(path).module()(y, b)
    assert torch.equal(got, _previous(y, b, "mish"))


def test_wrong_operands_raise():
    y, b = _sum_and_bias(8, seed=4)
    with pytest.raises(ValueError, match="no kernel code"):
        ce.conv_epilogue_cuda(y, b, "selu")
    with pytest.raises(ValueError, match="float32 sum"):
        ce.conv_epilogue_cuda(y.to(torch.bfloat16), b, "mish")
    with pytest.raises(ValueError, match="bias"):
        ce.conv_epilogue_cuda(y, b[:4], "mish")


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ulps(a, b):
    """Distance of two bf16 tensors in units in the last place (signed
    zeros equal)."""
    def key(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return (key(a) - key(b)).abs()


def _served(net) -> list:
    """The conv layers a request serves outside the region kernel, in
    order: the region remainders' steps and the layers after."""
    kernel = temit.kernel_conv_indices(net.graph)
    return [l for l in net.graph.layers
            if l.kind == "convolutional" and l.index not in kernel]


def _check(y, b, act, stats):
    got = ce.conv_epilogue_cuda(y, b, act)
    want = ce.conv_epilogue_plain(y, b, act)
    d = _ulps(got, want)
    n, diff = stats.get(act, (0, 0))
    stats[act] = (n + d.numel(), diff + int((d > 0).sum()))
    limit = 0 if act in BITWISE else 1
    assert int(d.max()) <= limit, (act, tuple(y.shape), int(d.max()))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_served_shapes(cuda, monkeypatch):
    net, x, kw = cell_net("yolov4-608.serve-b8", cuda)
    seen, stats = [], {}
    real = ce.conv_epilogue

    def recorder(y, b, act):
        seen.append((tuple(y.shape), act, y.is_contiguous(),
                     y.data_ptr() % 16 == 0))
        for a in BITWISE + ONE_ULP:
            _check(y, b, a, stats)
        return real(y, b, act)

    monkeypatch.setattr(ce, "conv_epilogue", recorder)
    net.submit_detect_device(x, **kw)
    torch.cuda.synchronize()
    served = _served(net)
    assert [(s[0][1:], s[1]) for s in seen] == [
        ((l.out_h, l.out_w, l.n), l.activation) for l in served]
    assert all(s[0][0] == x.shape[0] for s in seen)
    assert all(s[2] and s[3] for s in seen), [s for s in seen
                                              if not (s[2] and s[3])]
    print(f"\n{len(seen)} served convs, {len({s[0] for s in seen})} shapes;"
          " share of elements that differ from the plain version:")
    for act, (n, diff) in stats.items():
        print(f"  {act}: {diff} of {n} ({100 * diff / n:.6f}%)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 5, 57), (2, 19, 19, 255),
                                   (1, 1, 1, 7), (3, 4, 4, 64)])
def test_cuda_ragged_shapes(cuda, shape):
    y, b = _sum_and_bias(shape[-1], seed=sum(shape), shape=shape[:-1])
    y, b = y.to(cuda), b.to(cuda)
    stats = {}
    for act in sorted(ACT_CODES):
        if act in BITWISE + ONE_ULP:
            _check(y, b, act, stats)
        else:
            d = _ulps(ce.conv_epilogue_cuda(y, b, act),
                      ce.conv_epilogue_plain(y, b, act))
            assert int(d.max()) <= 1, act
    # a sum that is no NHWC-contiguous tensor is copied, not misread
    t = y.transpose(1, 2)
    assert torch.equal(ce.conv_epilogue_cuda(t, b, "leaky"),
                       ce.conv_epilogue_plain(t, b, "leaky"))


@pytest.mark.cuda
def test_cuda_one_launch_per_served_conv(cuda):
    net, x, kw = cell_net("yolov4-608.serve-b8", cuda)
    net.submit_detect_device(x, **kw)
    torch.cuda.synchronize()
    served = _served(net)
    before = ce.launches
    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        net.submit_detect_device(x, **kw)
        torch.cuda.synchronize()
    (req,) = spans.requests()
    spans.clear()
    assert ce.launches - before == len(served) == req.counts[
        "conv_epilogues_fused"] > 0


@pytest.mark.cuda
def test_cuda_int8_leaky_epilogue(cuda, monkeypatch):
    """Each quantized conv of the Gaussian YOLOv3 cell on its own served
    input: the GEMM's leaky equals the previous cast-then-activation
    bitwise, in bf16 and in f32."""
    net, x, kw = cell_net("gaussian-yolov3-512-int8.serve-b32", cuda)
    real = temit.conv_block_int8
    checked = []

    def compare(xin, p, l, *, compute_dtype=None):
        out = real(xin, p, l, compute_dtype=compute_dtype)
        padding = tconv.darknet_conv_padding(
            l.size, l.pad, l.dilation, (l.h, l.w), (l.stride_y, l.stride_x),
            (l.out_h, l.out_w))
        geo = dict(size=l.size, stride=(l.stride_y, l.stride_x),
                   padding=padding, out_hw=(l.out_h, l.out_w))
        for dt in (torch.bfloat16, torch.float32):
            new = real(xin, p, l, compute_dtype=dt)
            old = apply_activation(tconv.conv2d_int8(xin, p, out_dtype=dt,
                                                     **geo), l.activation)
            assert new.dtype == old.dtype == dt
            assert torch.equal(new, old), (l.index, dt)
        checked.append((l.index, l.activation))
        return out

    monkeypatch.setattr(temit, "conv_block_int8", compare)
    net.submit_detect_device(x, **kw)
    torch.cuda.synchronize()
    regions = temit.region_conv_indices(net.graph)
    assert [i for i, _ in checked] == [
        l.index for l in net.graph.layers
        if "w_q" in net.params[l.index] and l.index not in regions]
    assert len(checked) >= 60 and {a for _, a in checked} == {"leaky"}
