"""The fused region: its plain torch version against darknet_tpu's Pallas
kernel (interpret mode) and packed XLA region, and the CUDA kernels'
tiling against the plain version through torch emulations that read the
same tables the kernels read: the f32 FFMA kernel (step table, slot
extents, shared-memory layout, edge masks) and the bf16 tensor-core
kernel (pitched, channel-padded slots, the per-step (N_pad, K) weights,
the k16 address rows, m16 row groups, warp passes, the epilogue order).

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
from tests.torch_params import chip_smoke

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


def emulate(plan, x, weights, biases, tile):
    """Run the f32 kernel's algorithm with torch ops: per tile, every slot
    in one flat shared-memory buffer at the table's offsets and extents,
    masks after every step, the centre tile written out."""
    kp = cfr.kernel_plan(plan, 4, tile=tile)
    tab = kp.table.tolist()
    n_steps, n_slots, t, h, w, stem, _raw_c, in_s, out_s, tiles_x = tab[:10]
    slots = [tab[12 + 6 * i:18 + 6 * i] for i in range(n_slots)]
    base = 12 + 6 * n_slots
    steps = [tab[base + 16 * i:base + 16 * (i + 1)] for i in range(n_steps)]
    wbuf, bbuf = cfr.pack_weights(kp, weights, biases, torch.float32)
    xs = space_to_depth(x) if stem else x
    b = x.shape[0]
    size = max(s[5] + s[0] * s[3] * s[4] for s in slots)
    out = torch.zeros((b, h, w, slots[out_s][0]))
    xpad = torch.nn.functional.pad(xs, (0, 0, 8, t + 8, 8, t + 8))

    for ti in range(kp.tiles_y * tiles_x):
        ty0, tx0 = (ti // tiles_x) * t, (ti % tiles_x) * t
        sm = torch.full((b, size), float("nan"))

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
                return view(s)[:, r0:r0 + eh_o, c0:c0 + ew_o]

            if kind == 1:
                y = window(st[10], 0, 0) + window(st[11], 0, 0)
            else:
                npad, kh, kw, pt, pl, nsrc = st[4:10]
                srcs = st[10:10 + nsrc]
                c_tot = sum(slots[s][0] for s in srcs)
                wt = wbuf[st[14]:st[14] + kh * kw * c_tot * npad].view(
                    kh, kw, c_tot, npad)[..., :n]
                acc = torch.zeros((b, eh_o, ew_o, n))
                for ky in range(kh):
                    for kx in range(kw):
                        coff = 0
                        for s in srcs:
                            cs = slots[s][0]
                            acc += window(s, ky - pt, kx - pl) @ \
                                wt[ky, kx, coff:coff + cs]
                            coff += cs
                y = acc + bbuf[st[15]:st[15] + n]
            y = tact.ACTIVATION_FNS[CODE_ACT[code]](y)
            view(o)[:] = torch.where(in_img(o), y, torch.zeros_like(y))
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
    elif which == "yolov4-tiny":                         # no stem, C = 32
        g, _npar, tp = _setup(model_zoo.yolov4_tiny_cfg(64, 64), seed=2)
        _, tsub = _prefix(g)
    elif which == "wide":            # no stem; narrowed 1024-channel passes
        smoke = chip_smoke()
        g, _npar, tp = _setup(smoke.conv_stack_cfg(16, smoke.WIDE_LAYERS),
                              seed=4)
        tsub = tfr.plan_graph_regions(g, stem=True)[1]   # whole stride-1
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
    got = emulate(tsub, x, ws, bs, tile)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def _warp_split_covers(st, m_tiles, warps):
    """The tensor-core kernel's passes and warp items (conv_step) cover
    every (m16 tile, n8 tile) of a step exactly once."""
    n_pad, n_pass, mip, mi, nb = st[4], st[17], st[18], st[19], st[20]
    items_n = n_pass // (8 * nb)
    m_items = -(-m_tiles // mi)
    passes_m = -(-m_items // mip)
    assert n_pad % n_pass == 0 and 0 < items_n <= warps
    assert mi * nb <= 16 and (mi, nb) in cfr.MMA_SHAPES
    seen = []
    for p in range(n_pad // n_pass * passes_m):
        pn, pm = divmod(p, passes_m)
        for warp in range(warps):
            wn, wm = warp % items_n, warp // items_n
            mitem = pm * mip + wm
            if wm >= mip or mitem >= m_items:
                continue
            for i in range(mi):
                if mitem * mi + i < m_tiles:
                    seen += [(mitem * mi + i, pn * n_pass // 8 + wn * nb + j)
                             for j in range(nb)]
    assert sorted(seen) == [(m, n) for m in range(m_tiles)
                            for n in range(n_pad // 8)]


def emulate_tc(plan, x, weights, biases, tile, threads=None):
    """Run the tensor-core kernel's algorithm with torch ops: per tile,
    every slot in one flat shared-memory buffer (NaN until written) at the
    table's offsets, extents and pitches with channels zero-padded to 16;
    per conv step the weights as pack_weights lays them out ((N_pad, K),
    K ordered tap, source, channel), A rows gathered per m16 tile (the
    ragged tail re-reads the last pixel and is not stored), the f32 sum
    taken k16 by k16 in the kernel's order, then + bias, round, the
    activation, round, the image mask; the centre tile written out."""
    kp = cfr.kernel_plan(plan, 2, tile=tile) if threads is None else \
        cfr.tc_kernel_plan(plan, tile, threads)
    tab = kp.table.tolist()
    n_steps, n_slots, t, h, w, stem, _raw_c, in_s, out_s, tiles_x = tab[:10]
    ring_off, ring = tab[10:12]
    ns, ni = cfr.TC_SLOT_INTS, cfr.TC_STEP_INTS
    slots = [tab[12 + ns * i:12 + ns * (i + 1)] for i in range(n_slots)]
    base = 12 + ns * n_slots
    steps = [tab[base + ni * i:base + ni * (i + 1)] for i in range(n_steps)]
    assert kp.smem_bytes == 2 * (ring_off + 2 * ring)
    for c, _oy, _ox, eh, ew, off, cp, pitch in slots:
        assert cp % 16 == 0 and c <= cp and pitch == cp + 8
        assert off % 8 == 0 and off + eh * ew * pitch <= ring_off
    wbuf, bbuf = cfr.pack_weights(kp, weights, biases, torch.bfloat16)
    xs = (space_to_depth(x) if stem else x).to(torch.bfloat16).float()
    b = x.shape[0]
    out = torch.zeros((b, h, w, slots[out_s][0]))
    xpad = torch.nn.functional.pad(xs, (0, 0, 8, t + 8, 8, t + 8))

    def rnd(v):
        return v.to(torch.bfloat16).float()

    for ti in range(kp.tiles_y * tiles_x):
        ty0, tx0 = (ti // tiles_x) * t, (ti % tiles_x) * t
        sm = torch.full((b, ring_off), float("nan"))

        def addr(s, r, q):
            """Element offset of channel 0 of tile-relative pixels."""
            _c, oy, ox, eh, ew, off, _cp, pitch = slots[s]
            assert bool(((r - oy >= 0) & (r - oy < eh)).all()), "row extent"
            assert bool(((q - ox >= 0) & (q - ox < ew)).all()), "col extent"
            return off + ((r - oy) * ew + (q - ox)) * pitch

        def pixels(s):
            _c, oy, ox, eh, ew = slots[s][:5]
            m = torch.arange(eh * ew)
            return oy + m // ew, ox + m % ew

        def keep(r, q):
            return (((ty0 + r >= 0) & (ty0 + r < h) & (tx0 + q >= 0)
                     & (tx0 + q < w)))[None, :, None]

        def store(s, r, q, y):
            idx = addr(s, r, q)[:, None] + torch.arange(y.shape[-1])
            sm[:, idx] = torch.where(keep(r, q), y, torch.zeros_like(y))

        c, oy, ox, eh, ew, _off, cp, _p = slots[in_s]
        r, q = pixels(in_s)
        v = xpad[:, 8 + ty0 + r, 8 + tx0 + q]
        store(in_s, r, q, torch.nn.functional.pad(v, (0, cp - c)))
        for st in steps:
            kind, code, o = st[:3]
            r, q = pixels(o)
            cp_o = slots[o][6]
            if kind == 1:
                ch = torch.arange(cp_o)
                va = sm[:, addr(st[10], r, q)[:, None] + ch]
                vb = sm[:, addr(st[11], r, q)[:, None] + ch]
                y = rnd(va + vb)
            else:
                n_pad, kh, kw, pt, pl, nsrc = st[4:10]
                w_off, b_off, k_tot = st[14:17]
                assert n_pad == cp_o and st[17] * cfr.WPITCH <= ring
                m_tiles = -(-len(r) // 16)
                _warp_split_covers(st, m_tiles, kp.threads // 32)
                rows = torch.arange(16 * m_tiles).clamp(max=len(r) - 1)
                ra, qa = r[rows], q[rows]
                wmat = wbuf[w_off:w_off + n_pad * k_tot].view(
                    n_pad, k_tot).float()
                ctp = k_tot // (kh * kw)
                acc = torch.zeros((b, len(rows), n_pad))
                for k in range(0, k_tot, 16):
                    tap, rem = divmod(k, ctp)
                    ky, kx = divmod(tap, kw)
                    for s in st[10:10 + nsrc]:
                        if rem < slots[s][6]:
                            break
                        rem -= slots[s][6]
                    idx = addr(s, ra + ky - pt, qa + kx - pl) + rem
                    # the kernel reads the k16 row's base + r*row + q*pitch
                    g = 4 * (st[21] + k // 16)
                    base, row, pitch, _ = tab[g:g + 4]
                    assert torch.equal(2 * idx, base + ra * row + qa * pitch)
                    a = sm[:, idx[:, None] + torch.arange(16)]
                    acc += a @ wmat[:, k:k + 16].T
                y = rnd(acc[:, :len(r)] + bbuf[b_off:b_off + n_pad])
            y = rnd(tact.ACTIVATION_FNS[CODE_ACT[code]](y))
            store(o, r, q, y)
        c, oy, ox, eh, ew, _off, _cp, pitch = slots[out_s]
        th, tw = min(t, h - ty0), min(t, w - tx0)
        r = torch.arange(th).repeat_interleave(tw)
        q = torch.arange(tw).repeat(th)
        v = sm[:, addr(out_s, r, q)[:, None] + torch.arange(c)]
        out[:, ty0:ty0 + th, tx0:tx0 + tw] = v.view(b, th, tw, c)
    return out


@pytest.mark.parametrize("which,tile,threads", [
    ("yolov4", 12, None), ("yolov4", 8, None), ("yolov4", 4, None),
    ("yolov4", 16, None), ("yolov4", 12, 256), ("csp", 12, None),
    ("random116", 12, None), ("random162", 8, None),
    ("random450", 12, None), ("yolov4-tiny", 8, None), ("wide", 4, None)])
def test_kernel_tiling_bf16(which, tile, threads, yolov4_64):
    """The tensor-core kernel's addressing, emulated, against the plain
    version in bf16: within one ulp of the output's scale."""
    tsub, tp = _emulation_case(which, yolov4_64)
    x = torch.from_numpy(_input(tsub, b=1, seed=tile))
    ws, bs = tfr.step_weights(tsub.steps, tp, torch.bfloat16)
    want = tfr.region_plain(tsub, x, ws, bs,
                            compute_dtype=torch.bfloat16).float()
    got = emulate_tc(tsub, x, ws, bs, tile, threads)
    assert not torch.isnan(got).any()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0 ** -7 * scale


def test_kernel_plan_fits_the_card():
    """FFMA (f32): two blocks per SM.  Tensor cores (bf16): the measured
    choice, 16x16 tiles at 512 threads, one block per SM (PERF.md); 12x12
    fits two 256-thread blocks per SM; 24x24 does not fit the card."""
    g = _setup(model_zoo.yolov4_cfg(608, 608))[0]
    _, tsub = _prefix(g)
    for elem in (4, 2):
        kp = cfr.kernel_plan(tsub, elem)
        assert kp.smem_bytes <= cfr.SMEM_MAX
        assert kp.tiles_y == -(-304 // kp.tile)
        assert kp.table.dtype == np.int32
    assert cfr.kernel_plan(tsub, 4).smem_bytes <= 113 * 1024
    kp = cfr.kernel_plan(tsub, 2)
    assert (kp.tile, kp.threads, kp.tiles_y) == (16, 512, 19)
    assert kp.tensor_cores and not cfr.kernel_plan(tsub, 4).tensor_cores
    assert cfr.tc_kernel_plan(tsub, 12, 256).smem_bytes <= \
        113 * 1024                                      # two blocks per SM
    with pytest.raises(ValueError):
        cfr.kernel_plan(tsub, 2, tile=24)
    plan = tfr.plan_graph_regions(g, stem=True)[0]
    with pytest.raises(ValueError):
        cfr.kernel_plan(plan, 4)                        # strided: no


def _kernel_plans(cfg):
    """Every plan the forward can give region_call for a cfg: each
    region's stride-1 prefix, or the whole region where it is stride-1,
    with the stem folded and not."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = build_graph(cfg)
    for stem in (True, False):
        for plan in tfr.plan_graph_regions(g, stem=stem).values():
            pre = tfr.hybrid_prefix(plan)
            if pre is not None:
                yield pre[0]
            elif not plan.xla_only:
                yield plan


def _family_cfgs(family):
    if family == "zoo":
        return [fn(px, px) for fn in (*model_zoo.MODELS.values(),
                                      model_zoo.yolov3_spp_cfg)
                for px in (608, 416, 64)]
    if family == "csp":
        return [CSP_CFG]
    if family == "random":
        # seed 13 draws a cfg the graph builder rejects
        return [random_cfg(s) for s in (116, 162, 450, *range(13),
                                        *range(14, 40))]
    smoke = chip_smoke()                             # wide conv stacks
    return [smoke.conv_stack_cfg(px, [(n1, 3)] + [(n2, k), (n3, k)] * depth)
            for px in (64, 160) for n1 in (16, 64) for n2 in (512, 1024)
            for n3 in (64, 512) for k in (1, 3) for depth in (1, 3)]


@pytest.mark.parametrize("family", ["zoo", "csp", "random", "wide"])
def test_kernel_plan_takes_every_bf16_plan(family):
    """Every plan whose dense bf16 slots fit the card at one of the FFMA
    kernel's tiles (the rule under which the bf16 path ran on the FFMA
    kernel) gets a tensor-core plan that fits.  Wide steps (512-1024
    channels) fit only with narrowed weight passes at the smallest tile,
    and the wide family holds such plans."""
    taken = narrowed = 0
    for cfg in _family_cfgs(family):
        for sub in _kernel_plans(cfg):
            cands = [t for t in cfr.TILES if t <= max(sub.h, 2 * sub.w2)]
            if not any(cfr._ffma_layout(sub, t, 2)[2] <= cfr.SMEM_MAX
                       for t in cands or cfr.TILES[-1:]):
                continue
            kp = cfr.kernel_plan(sub, 2)
            assert kp.tensor_cores and kp.smem_bytes <= cfr.SMEM_MAX
            taken += 1
            narrowed += cfr._tc_plan(sub, kp.tile, kp.threads,
                                     cfr._slot_ids(sub))[0] > cfr.SMEM_MAX
    assert taken > 0
    assert narrowed > 0 or family != "wide"


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


@pytest.mark.parametrize("elem", [2, 4])
def test_launch_refuses_another_dtype(elem, yolov4_64):
    """A plan's table fits one kernel: launch takes only the plan's dtype
    (bfloat16 for a tensor-core plan, float32 for an FFMA plan) and
    raises before it loads the kernel."""
    g, _npar, tp = yolov4_64
    _, tsub = _prefix(g)
    kp = cfr.kernel_plan(tsub, elem)
    own = torch.bfloat16 if elem == 2 else torch.float32
    other = torch.float32 if elem == 2 else torch.bfloat16
    ws, bs = tfr.step_weights(tsub.steps, tp, own)
    wbuf, bbuf = cfr.pack_weights(kp, ws, bs, own)
    x = torch.from_numpy(_input(tsub, b=1)).to(other)
    tab = torch.from_numpy(kp.table)
    before = cfr.launches
    with pytest.raises(ValueError, match="plan takes"):
        cfr.launch(kp, tab, wbuf, bbuf, x, tsub.out_c)
    with pytest.raises(ValueError, match="plan takes"):
        cfr.launch(kp, tab, wbuf.to(other), bbuf, x.to(own), tsub.out_c)
    assert cfr.launches == before
