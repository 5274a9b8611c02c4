"""The fused region: its plain torch version against darknet_tpu's Pallas
kernel (interpret mode) and packed XLA region, and the CUDA kernel's
tiling (step table, slot extents, shared-memory layout, edge masks)
against the plain version through a torch emulation that reads the same
table the kernel reads.

Tolerances: rtol 1e-4 / atol 1e-5 in f32, as tests/test_fused_region.py
(the packings sum in another order); bf16 at 2^-7 of the output's scale
(one bf16 ulp: the emulation and the plain version each round a conv's
f32 sum once, in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from darknet_tpu import model_zoo
from darknet_tpu.graph.builder import build_graph
from darknet_tpu.nn import params as jparams
from darknet_tpu.ops import stem as jstem
from darknet_tpu.ops.pallas import fused_region as jfr
from darknet_tpu_torch.nn import params as tparams
from darknet_tpu_torch.ops import activations as tact
from darknet_tpu_torch.ops import fused_region as tfr
from darknet_tpu_torch.ops.cuda import fused_region as cfr
from darknet_tpu_torch.ops.stem import space_to_depth
from tests.test_fused_region import CSP_CFG
from tests.test_reference_fuzz import random_cfg

torch.set_num_threads(2)
CODE_ACT = {v: k for k, v in cfr.ACT_CODES.items()}


def _setup(cfg, seed=0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
    npar = jparams.fuse_conv_batchnorm(g, jparams.init_params(g, seed=seed))
    return g, npar, tparams.params_to_torch(g, npar, "cpu")


@pytest.fixture(scope="module")
def yolov4_64():
    return _setup(model_zoo.yolov4_cfg(64, 64))


def _input(plan, b=2, seed=0):
    rng = np.random.default_rng(seed)
    if plan.stem:
        shape = (b, 2 * plan.h, 4 * plan.w2, plan.in_c // 4)
        return rng.uniform(0, 1, shape).astype(np.float32)
    shape = (b, plan.h, 2 * plan.w2, plan.in_c)
    return rng.normal(0, 1, shape).astype(np.float32)


def _prefix(g, a=None):
    jplans = jfr.plan_graph_regions(g, stem=True)
    tplans = tfr.plan_graph_regions(g, stem=True)
    a = min(jplans) if a is None else a
    jsub, k = jfr.hybrid_prefix(jplans[a])
    tsub, k2 = tfr.hybrid_prefix(tplans[a])
    assert k == k2
    return jsub, tsub


def _jax_region_call(jsub, npar, x):
    """darknet_tpu's hybrid prefix: build_region_call in interpret mode."""
    b = x.shape[0]
    xs = jstem.space_to_depth(x) if jsub.stem else jnp.asarray(x)
    xp = xs.reshape(b, jsub.h, jsub.w2, 2 * jsub.in_c).astype(jnp.float32)
    weights = [jfr.pack_step_weights(st, st.w_fn(npar))
               for st in jsub.conv_steps]
    biases = [jfr.pack_step_bias(st, st.b_fn(npar))
              for st in jsub.conv_steps]
    call = jfr.build_region_call(jsub, b, compute_dtype=jnp.float32,
                                 interpret=True)
    y = call(xp, weights, biases)
    return np.asarray(y).reshape(b, jsub.h, 2 * jsub.w2, jsub.out_c)


def _plain(tsub, tp, x, dtype=torch.float32):
    ws, bs = tfr.step_weights(tsub.steps, tp, dtype)
    return tfr.region_plain(tsub, torch.from_numpy(x), ws, bs,
                            compute_dtype=dtype)


@pytest.mark.parametrize("which", ["yolov4", "csp", "random116"])
def test_plain_matches_pallas_kernel(which, yolov4_64):
    if which == "yolov4":
        g, npar, tp = yolov4_64
    elif which == "csp":
        g, npar, tp = _setup(CSP_CFG, seed=3)
    else:
        g, npar, tp = _setup(random_cfg(116), seed=1)
    jsub, tsub = _prefix(g)
    x = _input(tsub)
    want = _jax_region_call(jsub, npar, x)
    got = _plain(tsub, tp, x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_plain_matches_run_region_xla(yolov4_64):
    """The whole strided region 0-23, against the packed XLA region."""
    g, npar, tp = yolov4_64
    jplan = jfr.plan_graph_regions(g, stem=True)[0]
    tplan = tfr.plan_graph_regions(g, stem=True)[0]
    x = _input(tplan)
    want = np.asarray(jfr.run_region_xla(jplan, npar, x,
                                         compute_dtype=jnp.float32))
    ws, bs = tfr.step_weights(tplan.steps, tp, torch.float32)
    got = tfr.region_plain(tplan, torch.from_numpy(x), ws, bs).numpy()
    assert got.shape == want.shape == (2, 16, 16, 128)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# The kernel's tiling, emulated
# --------------------------------------------------------------------------


def emulate(plan, x, weights, biases, dtype, tile):
    """Run the kernel's algorithm with torch ops: per tile, every slot in
    one flat shared-memory buffer at the table's offsets and extents,
    masks after every step, the centre tile written out."""
    kp = cfr.kernel_plan(plan, torch.tensor([], dtype=dtype).element_size(),
                         tile=tile)
    tab = kp.table.tolist()
    n_steps, n_slots, t, h, w, stem, _raw_c, in_s, out_s, tiles_x = tab[:10]
    slots = [tab[12 + 6 * i:18 + 6 * i] for i in range(n_slots)]
    base = 12 + 6 * n_slots
    steps = [tab[base + 16 * i:base + 16 * (i + 1)] for i in range(n_steps)]
    wbuf, bbuf = cfr.pack_weights(kp, weights, biases, dtype)
    xs = (space_to_depth(x) if stem else x).to(dtype)
    b = x.shape[0]
    size = max(s[5] + s[0] * s[3] * s[4] for s in slots)
    out = torch.zeros((b, h, w, slots[out_s][0]), dtype=dtype)
    xpad = torch.nn.functional.pad(xs, (0, 0, 8, t + 8, 8, t + 8))

    for ti in range(kp.tiles_y * tiles_x):
        ty0, tx0 = (ti // tiles_x) * t, (ti % tiles_x) * t
        sm = torch.full((b, size), float("nan"), dtype=dtype)

        def view(i):
            c, _oy, _ox, eh, ew, off = slots[i]
            return sm[:, off:off + eh * ew * c].view(b, eh, ew, c)

        def in_img(i):
            _c, oy, ox, eh, ew, _ = slots[i]
            gy = ty0 + oy + torch.arange(eh)
            gx = tx0 + ox + torch.arange(ew)
            return (((gy >= 0) & (gy < h))[:, None]
                    & ((gx >= 0) & (gx < w))[None, :])[None, :, :, None]

        c, oy, ox, eh, ew, _ = slots[in_s]
        v = xpad[:, 8 + ty0 + oy:8 + ty0 + oy + eh,
                 8 + tx0 + ox:8 + tx0 + ox + ew]
        view(in_s)[:] = torch.where(in_img(in_s), v, torch.zeros_like(v))
        for st in steps:
            kind, code, o = st[0], st[1], st[2]
            n, oy_o, ox_o, eh_o, ew_o, _ = slots[o]

            def window(s, dy, dx):
                _c, oy_s, ox_s, eh_s, ew_s, _ = slots[s]
                r0, c0 = oy_o + dy - oy_s, ox_o + dx - ox_s
                assert 0 <= r0 and r0 + eh_o <= eh_s, "row extent"
                assert 0 <= c0 and c0 + ew_o <= ew_s, "col extent"
                return view(s)[:, r0:r0 + eh_o, c0:c0 + ew_o].float()

            if kind == 1:
                y = (window(st[10], 0, 0) + window(st[11], 0, 0)).to(dtype)
            else:
                npad, kh, kw, pt, pl, nsrc = st[4:10]
                srcs = st[10:10 + nsrc]
                c_tot = sum(slots[s][0] for s in srcs)
                wt = wbuf[st[14]:st[14] + kh * kw * c_tot * npad].view(
                    kh, kw, c_tot, npad)[..., :n].float()
                acc = torch.zeros((b, eh_o, ew_o, n))
                for ky in range(kh):
                    for kx in range(kw):
                        coff = 0
                        for s in srcs:
                            cs = slots[s][0]
                            acc += window(s, ky - pt, kx - pl) @ \
                                wt[ky, kx, coff:coff + cs]
                            coff += cs
                y = (acc + bbuf[st[15]:st[15] + n]).to(dtype)
            y = tact.ACTIVATION_FNS[CODE_ACT[code]](y.float())
            view(o)[:] = torch.where(in_img(o), y, torch.zeros_like(y)).to(
                dtype)
        c, oy, ox, eh, ew, _ = slots[out_s]
        th, tw = min(t, h - ty0), min(t, w - tx0)
        out[:, ty0:ty0 + th, tx0:tx0 + tw] = \
            view(out_s)[:, -oy:-oy + th, -ox:-ox + tw]
    return out


def _emulation_case(which, yolov4_64):
    if which == "yolov4":
        g, _npar, tp = yolov4_64
        _, tsub = _prefix(g)
    elif which == "csp":
        g, _npar, tp = _setup(CSP_CFG, seed=3)
        tsub = tfr.plan_graph_regions(g, stem=True)[0]   # whole stride-1
    else:
        seed = int(which[len("random"):])
        g, _npar, tp = _setup(random_cfg(seed), seed=1)
        _, tsub = _prefix(g)
    return tsub, tp


@pytest.mark.parametrize("which,tile", [
    ("yolov4", 8), ("yolov4", 12), ("yolov4", 4), ("csp", 12),
    ("csp", 4), ("random116", 12), ("random162", 8), ("random450", 12)])
def test_kernel_tiling_matches_plain(which, tile, yolov4_64):
    tsub, tp = _emulation_case(which, yolov4_64)
    x = torch.from_numpy(_input(tsub, seed=tile))
    ws, bs = tfr.step_weights(tsub.steps, tp, torch.float32)
    want = tfr.region_plain(tsub, x, ws, bs)
    got = emulate(tsub, x, ws, bs, torch.float32, tile)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_kernel_tiling_bf16(yolov4_64):
    tsub, tp = _emulation_case("yolov4", yolov4_64)
    x = torch.from_numpy(_input(tsub, b=1))
    ws, bs = tfr.step_weights(tsub.steps, tp, torch.bfloat16)
    want = tfr.region_plain(tsub, x, ws, bs,
                            compute_dtype=torch.bfloat16).float()
    got = emulate(tsub, x, ws, bs, torch.bfloat16, 12).float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** -7 * scale


def test_kernel_plan_fits_the_card():
    g = _setup(model_zoo.yolov4_cfg(608, 608))[0]
    _, tsub = _prefix(g)
    for elem in (4, 2):
        kp = cfr.kernel_plan(tsub, elem)
        assert kp.smem_bytes <= 113 * 1024           # two blocks per SM
        assert kp.tiles_y == -(-304 // kp.tile)
        assert kp.table.dtype == np.int32
    assert cfr.kernel_plan(tsub, 2).tile == 12          # 304 = 25*12 + 4
    plan = tfr.plan_graph_regions(g, stem=True)[0]
    with pytest.raises(ValueError):
        cfr.kernel_plan(plan, 4)                        # strided: no


def test_region_call_dispatch(yolov4_64):
    """A CPU tensor runs the plain version and launches nothing; any
    other non-CUDA device raises."""
    g, _npar, tp = yolov4_64
    _, tsub = _prefix(g)
    x = torch.from_numpy(_input(tsub, b=1))
    ws, bs = tfr.step_weights(tsub.steps, tp, torch.float32)
    before = cfr.launches
    got = cfr.region_call(tsub, x, ws, bs)
    assert cfr.launches == before
    torch.testing.assert_close(got, tfr.region_plain(tsub, x, ws, bs),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        cfr.region_call(tsub, x.to("meta"), ws, bs)
