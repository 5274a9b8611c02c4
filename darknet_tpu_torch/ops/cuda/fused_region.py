"""Wrapper of the CUDA fused-region kernels (`csrc/fused_region.cu`).

`region_call(plan, x, weights, biases)` runs a stride-1 `RegionPlan` in
one launch.  x is the raw net input (B, 2H, 2W, C) for a stem plan, else
the region's NHWC input (B, H, W, in_c); weights/biases are the BN-folded
per-conv-step HWIO weights and f32 biases (`fused_region.step_weights`).
Returns the region output (B, H, W, out_c) in the compute dtype.

Two kernels share the step table's header: float32 runs the FFMA kernel
over dense NHWC slots; bfloat16 runs the tensor-core kernel (`mma.sync`
m16n8k16), whose slots keep channels padded to 16 at a pitch of
channels + 8 (conflict-free `ldmatrix` rows) and whose weights are one
(N_pad, K) K-contiguous matrix per step, K ordered (tap, source, channel).

`region_call` goes through the custom op `darknet_tpu_torch::region`
(`ops/library.py`), which carries the plan as its JSON string and which
`torch.export` records as a node.  A CPU tensor goes to the plain
version (`fused_region.region_plain`); a CUDA tensor launches the kernel
(`region_cuda`, the op's CUDA backend) or raises.  `launches` counts the
kernel launches, and `variant_launches` counts them by kernel.

The same source holds the one-pass conv epilogue, which shares the
kernels' activations (`ACT_CODES`); its wrapper is
`ops/cuda/conv_epilogue.py`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from darknet_tpu_torch.ops.fused_region import IN_SLOT, ConvStep, RegionPlan

ACT_CODES = {"linear": 0, "leaky": 1, "relu": 2, "relu6": 3, "relie": 4,
             "ramp": 5, "mish": 6, "swish": 7, "logistic": 8, "loggy": 9,
             "tanh": 10, "hardtan": 11, "gelu": 12}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HDR, SLOT_INTS, STEP_INTS = 12, 6, 16       # FFMA table, as in the .cu
TC_SLOT_INTS, TC_STEP_INTS = 8, 22          # tensor-core table, as in the .cu
NC = 8                                      # output channels per thread
MAX_SRCS = 4
TILES = (32, 24, 16, 12, 8, 4)
SMEM_MAX = 227 * 1024
FFMA_THREADS = 256
# tensor-core kernel: K columns per staged weight chunk, the chunk's row
# pitch, the (m16 tiles, n8 tiles) per warp it is compiled for, its block
# and its tiles in order of preference: one 512-thread block per SM on
# 16x16 tiles beat 12x12 at two 256-thread blocks per SM at yolov4-608 b=8
# (chip_region_tiles.py, PERF.md)
KC = 64
WPITCH = KC + 8
MMA_SHAPES = ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4), (2, 8), (3, 2),
              (3, 4), (4, 2), (4, 4))
TC_THREADS = 512
TC_TILES = (16, 12, 8, 4)
PASS_CAPS = (256, 128, 64, 32, 16)

launches = 0
# launches by kernel: the tensor-core kernel (bf16 plans) and the FFMA one
variant_launches = {"region_tc_kernel": 0, "region_kernel": 0}


@dataclasses.dataclass
class KernelPlan:
    """The launch geometry and step table of one plan at one dtype."""

    tile: int
    tiles_y: int
    tiles_x: int
    smem_bytes: int
    table: np.ndarray            # int32, the layout of csrc/fused_region.cu
    n_pad: list                  # per conv step: output channels padded
    threads: int = FFMA_THREADS
    tensor_cores: bool = False
    # tc, per conv step: (channels, channels padded to 16) per source
    srcs_cp: list = dataclasses.field(default_factory=list)
    macs_per_tile: int = 0       # tc: multiply-adds one block executes


def _slot_channels(plan: RegionPlan) -> dict:
    chan = {IN_SLOT: plan.in_c}
    for s in plan.steps:
        chan[s.out_slot] = s.n if isinstance(s, ConvStep) else chan[s.a]
    return chan


def slot_extents(plan: RegionPlan, tile: int) -> dict:
    """Slot id -> (oy, ox, eh, ew): the tile-relative rectangle of each
    slot that its consumers read, derived backwards from the output's
    centre tile through every step's taps."""
    need = {plan.out_slot: (0, 0, 0, 0)}          # top, bottom, left, right
    for st in reversed(plan.steps):
        o = need.setdefault(st.out_slot, (0, 0, 0, 0))
        if isinstance(st, ConvStep):
            grow = (st.pt, st.kh - 1 - st.pt, st.pl_, st.kw - 1 - st.pl_)
            srcs = st.srcs
        else:
            grow, srcs = (0, 0, 0, 0), (st.a, st.b)
        want = tuple(a + g for a, g in zip(o, grow))
        for s in srcs:
            need[s] = tuple(max(a, b) for a, b in
                            zip(need.get(s, want), want))
    return {s: (-t, -l, tile + t + b, tile + l + r)
            for s, (t, b, l, r) in need.items()}


def _allocate(plan: RegionPlan, sizes: dict) -> tuple:
    """Shared-memory offsets (elements) with step liveness: the largest
    slot first, each at the lowest offset clear of every placed slot
    whose lifetime meets its own (first fit in step order left 14 KB of
    holes in yolov4's tensor-core layout at 12x12)."""
    last = {IN_SLOT: -1}
    for i, st in enumerate(plan.steps):
        last.setdefault(st.out_slot, i)
        for s in (st.srcs if isinstance(st, ConvStep) else (st.a, st.b)):
            last[s] = max(last.get(s, i), i)
    last[plan.out_slot] = len(plan.steps)
    order = sorted([(-1, IN_SLOT)] + [(i, st.out_slot)
                                      for i, st in enumerate(plan.steps)],
                   key=lambda e: -sizes[e[1]])
    placed: list = []                              # (off, size, first, slot)
    offs = {}
    peak = 0
    for i, slot in order:
        size = -(-sizes[slot] // 8) * 8
        off = 0
        for lo, sz, f, s in sorted(placed):
            if f > last[slot] or last[s] < i:      # lifetimes apart
                continue
            if off + size <= lo:
                break
            off = max(off, lo + sz)
        placed.append((off, size, i, slot))
        offs[slot] = off
        peak = max(peak, off + size)
    return offs, peak


def _round16(c: int) -> int:
    return -(-c // 16) * 16


def mma_config(mt: int, n16: int, warps: int, max_pass: int | None = None):
    """How the tensor-core kernel splits one conv step over its warps:
    (n_pass, m_items_per_pass, mi, nb).  The step's output is mt m16
    tiles by n16 n16 groups; a warp holds mi x nb m16n8 accumulator tiles
    (at most 16: 64 registers) for the whole K loop, so the output is cut
    into passes of n_pass channels (at most `max_pass`: the weight ring
    holds n_pass rows) and m_items_per_pass warp rows.  The cheapest split
    by rounds x (mma + ldmatrix per k16) wins; ties go to the smaller
    weight chunk."""
    best = None
    for pn in range(1, n16 + 1):
        if n16 % pn:
            continue
        ntp = 2 * n16 // pn                       # n8 tiles per pass
        if max_pass is not None and 8 * ntp > max_pass:
            continue
        for mi, nb in MMA_SHAPES:
            items_n = ntp // nb
            if ntp % nb or items_n > warps:
                continue
            mip = warps // items_n
            m_items = -(-mt // mi)
            passes_m = -(-m_items // mip)
            cost = pn * passes_m * (mi * nb + 0.5 * (mi + nb // 2) + 2)
            key = (cost, ntp, -nb)
            if best is None or key < best[0]:
                best = (key, (8 * ntp, mip, mi, nb))
    if best is None:
        raise ValueError(f"no warp split for {mt} m16 tiles x {n16} n16 "
                         f"groups over {warps} warps")
    return best[1]


def _tc_plan(plan: RegionPlan, tile: int, threads: int, ids: dict,
             max_pass: int | None = None):
    """The tensor-core kernel's layout at one tile: (smem bytes, [ring
    offset, ring buffer elements], slot rows, step rows (k16 rows indexed
    from 0), k16 rows, n_pad, srcs_cp, macs per tile)."""
    chan = _slot_channels(plan)
    cp = {s: _round16(c) for s, c in chan.items()}
    ext = slot_extents(plan, tile)
    offs, peak = _allocate(plan, {s: e[2] * e[3] * (cp[s] + 8)
                                  for s, e in ext.items()})
    slot_rows = []
    for s, _ in sorted(ids.items(), key=lambda kv: kv[1]):
        oy, ox, eh, ew = ext[s]
        slot_rows += [chan[s], oy, ox, eh, ew, offs[s], cp[s], cp[s] + 8]
    step_rows, n_pad, srcs_cp, meta = [], [], [], []
    w_off = b_off = macs = ring = 0
    for st in plan.steps:
        _oy, _ox, eh, ew = ext[st.out_slot]
        if not isinstance(st, ConvStep):
            step_rows += [1, ACT_CODES[st.act], ids[st.out_slot],
                          chan[st.a], cp[st.a], 0, 0, 0, 0, 2, ids[st.a],
                          ids[st.b]] + [0] * 10
            continue
        if len(st.srcs) > MAX_SRCS:
            raise ValueError(f"route concat of {len(st.srcs)} > "
                             f"{MAX_SRCS} sources")
        npd = cp[st.out_slot]
        s_cp = tuple((chan[s], cp[s]) for s in st.srcs)
        k_tot = st.kh * st.kw * sum(c for _, c in s_cp)
        mt = -(-(eh * ew) // 16)
        n_pass, mip, mi, nb = mma_config(mt, npd // 16, threads // 32,
                                         max_pass)
        srcs = [ids[s] for s in st.srcs] + [0] * (MAX_SRCS - len(st.srcs))
        step_rows += [0, ACT_CODES[st.act], ids[st.out_slot], st.n, npd,
                      st.kh, st.kw, st.pt, st.pl_, len(st.srcs), *srcs,
                      w_off, b_off, k_tot, n_pass, mip, mi, nb,
                      len(meta) // 4]
        meta += _k16_meta(st, ext, cp, offs)
        w_off += npd * k_tot
        b_off += npd
        macs += 16 * mt * npd * k_tot
        ring = max(ring, n_pass * WPITCH)
        n_pad.append(npd)
        srcs_cp.append(s_cp)
    ring_off = -(-peak // 64) * 64                 # 128-byte aligned ring
    smem = 2 * (ring_off + 2 * ring)
    return (smem, [ring_off, ring], slot_rows, step_rows, meta, n_pad,
            srcs_cp, macs)


def _k16_meta(st: ConvStep, ext: dict, cp: dict, offs: dict) -> list:
    """Per k16 group of a conv step (K ordered tap, source, channel): the
    A operand's shared-memory address as base + r * row + q * pitch
    bytes for a tile-relative output pixel (r, q), as 4 ints (base, row,
    pitch, 0).  A route concat is a K range per source."""
    rows = []
    for ky in range(st.kh):
        for kx in range(st.kw):
            for s in st.srcs:
                oy, ox, _eh, ew = ext[s]
                pitch = cp[s] + 8
                for c0 in range(0, cp[s], 16):
                    base = offs[s] + c0 + ((ky - st.pt - oy) * ew
                                           + kx - st.pl_ - ox) * pitch
                    rows += [2 * base, 2 * ew * pitch, 2 * pitch, 0]
    return rows


def _ffma_layout(plan: RegionPlan, tile: int, elem_bytes: int) -> tuple:
    """The FFMA kernel's dense NHWC slots at one tile: (extents, offsets,
    shared-memory bytes)."""
    chan = _slot_channels(plan)
    ext = slot_extents(plan, tile)
    offs, peak = _allocate(plan, {s: e[2] * e[3] * chan[s]
                                  for s, e in ext.items()})
    return ext, offs, peak * elem_bytes


def kernel_plan(plan: RegionPlan, elem_bytes: int,
                tile: int | None = None) -> KernelPlan:
    """Lay out the step table of the FFMA kernel (elem_bytes 4, float32)
    or the tensor-core kernel (elem_bytes 2, bfloat16) and pick its tile.
    FFMA: the largest tile whose shared memory fits two blocks per SM,
    else the largest under the card's limit.  Tensor cores: TC_THREADS
    threads and the first of TC_TILES under the card's limit, the weight
    ring cut down at the smallest tile if need be.  `tile` forces a
    choice (the CPU emulation test)."""
    if plan.xla_only or any(isinstance(s, ConvStep) and (s.sy, s.sx) != (1, 1)
                            for s in plan.steps):
        raise ValueError("the region kernel takes stride-1 plans only")
    if elem_bytes == 2:
        return tc_kernel_plan(plan, tile)
    chan = _slot_channels(plan)
    h, w = plan.h, 2 * plan.w2

    def layout(t):
        return _ffma_layout(plan, t, elem_bytes)

    if tile is None:
        two_per_sm = 113 * 1024
        cands = [t for t in TILES if t <= max(h, w)] or [TILES[-1]]
        sized = [(t, layout(t)) for t in cands]
        fit = [tl for tl in sized if tl[1][2] <= two_per_sm] or \
            [tl for tl in sized if tl[1][2] <= SMEM_MAX]
        if not fit:
            raise ValueError("region does not fit shared memory at any tile")
        tile, (ext, offs, smem) = fit[0]
    else:
        ext, offs, smem = layout(tile)
        if smem > SMEM_MAX:
            raise ValueError(f"tile {tile} needs {smem} B of shared memory")

    ids = _slot_ids(plan)
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    tab = [len(plan.steps), len(ids), tile, h, w, int(plan.stem),
           plan.in_c // 4 if plan.stem else plan.in_c,
           ids[IN_SLOT], ids[plan.out_slot], tiles_x, 0, 0]
    for s, _ in sorted(ids.items(), key=lambda kv: kv[1]):
        oy, ox, eh, ew = ext[s]
        tab += [chan[s], oy, ox, eh, ew, offs[s]]
    w_off = b_off = 0
    n_pad = []
    for st in plan.steps:
        if isinstance(st, ConvStep):
            if len(st.srcs) > MAX_SRCS:
                raise ValueError(f"route concat of {len(st.srcs)} > "
                                 f"{MAX_SRCS} sources")
            npd = -(-st.n // NC) * NC
            srcs = [ids[s] for s in st.srcs] + [0] * (MAX_SRCS - len(st.srcs))
            tab += [0, ACT_CODES[st.act], ids[st.out_slot], st.n, npd,
                    st.kh, st.kw, st.pt, st.pl_, len(st.srcs), *srcs,
                    w_off, b_off]
            w_off += st.kh * st.kw * st.c_tot * npd
            b_off += npd
            n_pad.append(npd)
        else:
            tab += [1, ACT_CODES[st.act], ids[st.out_slot], chan[st.a], 0,
                    0, 0, 0, 0, 2, ids[st.a], ids[st.b], 0, 0, 0, 0]
    return KernelPlan(tile=tile, tiles_y=tiles_y, tiles_x=tiles_x,
                      smem_bytes=smem, table=np.asarray(tab, np.int32),
                      n_pad=n_pad)


def _slot_ids(plan: RegionPlan) -> dict:
    ids = {IN_SLOT: 0}
    for st in plan.steps:
        ids.setdefault(st.out_slot, len(ids))
    return ids


def tc_kernel_plan(plan: RegionPlan, tile: int | None = None,
                   threads: int = TC_THREADS) -> KernelPlan:
    """The tensor-core kernel's plan (`kernel_plan` at elem_bytes 2).
    Where no tile fits with the passes mma_config prefers, the smallest
    tile takes passes of at most PASS_CAPS output channels, which shrink
    the weight ring.  `threads` other than TC_THREADS is for
    chip_region_tiles.py's sweep of block sizes."""
    h, w = plan.h, 2 * plan.w2
    ids = _slot_ids(plan)
    tiles = [tile] if tile is not None else \
        [t for t in TC_TILES if t <= max(h, w)] or list(TC_TILES[-1:])
    for t, cap in [(t, None) for t in tiles] + [(tiles[-1], c)
                                                 for c in PASS_CAPS]:
        laid = _tc_plan(plan, t, threads, ids, cap)
        if laid[0] <= SMEM_MAX:
            tile = t
            break
    else:
        raise ValueError(f"region does not fit shared memory: tile "
                         f"{tiles[-1]} needs {laid[0]} B")
    smem, ring, slot_rows, step_rows, meta, n_pad, srcs_cp, macs = laid
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    tab = [len(plan.steps), len(ids), tile, h, w, int(plan.stem),
           plan.in_c // 4 if plan.stem else plan.in_c,
           ids[IN_SLOT], ids[plan.out_slot], tiles_x, *ring]
    tab += slot_rows
    base4 = -(-(len(tab) + len(step_rows)) // 4)   # int4-aligned k16 rows
    for i in range(0, len(step_rows), TC_STEP_INTS):
        if step_rows[i] == 0:
            step_rows[i + TC_STEP_INTS - 1] += base4
    tab += step_rows
    tab += [0] * (4 * base4 - len(tab)) + meta
    return KernelPlan(tile=tile, tiles_y=tiles_y, tiles_x=tiles_x,
                      smem_bytes=smem,
                      table=np.asarray(tab, np.int32),
                      n_pad=n_pad, threads=threads, tensor_cores=True,
                      srcs_cp=srcs_cp, macs_per_tile=macs)


def pack_weights(kp: KernelPlan, weights, biases, dtype):
    """One flat weight buffer in `dtype` and one flat f32 bias buffer.
    FFMA: each step HWIO, output channels padded to NC.  Tensor cores:
    each step an (N_pad, K) matrix, K-contiguous and ordered (ky, kx,
    source, channel), every source's channels zero-padded to its slot's
    multiple of 16 and the output channels to N_pad."""
    ws, bs = [], []
    for i, (w, b, npd) in enumerate(zip(weights, biases, kp.n_pad)):
        pad = npd - w.shape[-1]
        w = torch.nn.functional.pad(w.to(dtype), (0, pad))
        if kp.tensor_cores:
            parts = torch.split(w, [c for c, _ in kp.srcs_cp[i]], dim=2)
            w = torch.cat([torch.nn.functional.pad(p, (0, 0, 0, cp - c))
                           for p, (c, cp) in zip(parts, kp.srcs_cp[i])],
                          dim=2).permute(3, 0, 1, 2)
        ws.append(w.reshape(-1))
        bs.append(torch.nn.functional.pad(b.float(), (0, pad)))
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous()


# (plan JSON, dtype, device) -> (kernel plan, its table on the card)
_plans: dict = {}
# (plan JSON, dtype, device, weight and bias pointers and shapes) ->
# (packed weights, packed biases, the source tensors: held, so that their
# pointers stay theirs while the entry lives)
_packed: dict = {}


def _bounded_put(cache: dict, key, value, size: int = 16):
    if len(cache) >= size:
        cache.pop(next(iter(cache)))
    cache[key] = value
    return value


def _prepared(plan, weights, biases, dtype, device):
    """Kernel plan, uploaded table and packed weights of a plan (a
    RegionPlan or its JSON string): the plan laid out once per JSON
    string, the weights packed once per weight tensors."""
    from darknet_tpu_torch.ops.library import parse_plan

    if not isinstance(plan, str):
        plan = plan.to_json()
    key = (plan, dtype, str(device))
    hit = _plans.get(key)
    if hit is None:
        kp = kernel_plan(parse_plan(plan),
                         torch.tensor([], dtype=dtype).element_size())
        hit = _bounded_put(_plans, key,
                           (kp, torch.from_numpy(kp.table).to(device)))
    kp, tab = hit
    wkey = key + tuple((t.data_ptr(), tuple(t.shape), t.stride())
                       for t in (*weights, *biases))
    packed = _packed.get(wkey)
    if packed is None:
        packed = _bounded_put(_packed, wkey, (
            *pack_weights(kp, weights, biases, dtype), list(weights),
            list(biases)))
    return kp, tab, packed[0], packed[1]


def _lib():
    from darknet_tpu_torch.ops.cuda.build import load

    lib = load("fused_region")
    lib.region_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.region_launch.restype = ctypes.c_int
    lib.region_error_string.argtypes = [ctypes.c_int]
    lib.region_error_string.restype = ctypes.c_char_p
    return lib


def region_call(plan, x, weights, biases, *,
                compute_dtype=torch.float32):
    """Run a stride-1 plan (a RegionPlan, or its `to_json` string) on x
    through the op `darknet_tpu_torch::region`: the plain version for a
    CPU tensor, the kernel for a CUDA tensor."""
    from darknet_tpu_torch.ops import library  # noqa: F401 (the ops)

    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"region_call: no kernel for device {x.device}")
    if not isinstance(plan, str):
        plan = plan.to_json()
    return torch.ops.darknet_tpu_torch.region.default(
        x, list(weights), list(biases), plan, compute_dtype)


def region_cuda(x, weights, biases, plan: str, dtype):
    """The op's CUDA backend: check the operands against the plan, lay out
    and pack once (`_prepared`), launch (counted in `launches`)."""
    from darknet_tpu_torch.ops.library import parse_plan

    if dtype not in _DTYPE_CODE:
        raise ValueError(f"region kernel takes float32 or bfloat16, "
                         f"not {dtype}")
    rp = parse_plan(plan)
    h, w = rp.h, 2 * rp.w2
    want = (2 * h, 2 * w, rp.in_c // 4) if rp.stem else (h, w, rp.in_c)
    if x.dim() != 4 or tuple(x.shape[1:]) != want:
        raise ValueError(f"region input must be (B, {want}), "
                         f"got {tuple(x.shape)}")
    if any(t.device != x.device for t in (*weights, *biases)):
        raise ValueError("region weights must be on the input's device")
    kp, tab, wbuf, bbuf = _prepared(plan, weights, biases, dtype, x.device)
    return launch(kp, tab, wbuf, bbuf, x.to(dtype).contiguous(), rp.out_c)


def launch(kp: KernelPlan, tab, wbuf, bbuf, x, out_c: int):
    """One launch of a prepared plan (`kernel_plan`, the table on the
    card, `pack_weights`) on x in the plan's dtype (bfloat16 for a
    tensor-core plan, else float32); counted in `launches`."""
    global launches
    dtype = torch.bfloat16 if kp.tensor_cores else torch.float32
    if x.dtype != dtype or wbuf.dtype != dtype:
        raise ValueError(f"a {'tensor-core' if kp.tensor_cores else 'FFMA'}"
                         f" plan takes {dtype}, got x {x.dtype}, weights "
                         f"{wbuf.dtype}")
    lib = _lib()
    out = torch.empty((x.shape[0], kp.table[3], kp.table[4], out_c),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.region_launch(
            _DTYPE_CODE[dtype], x.data_ptr(), out.data_ptr(),
            wbuf.data_ptr(), bbuf.data_ptr(), tab.data_ptr(), x.shape[0],
            kp.tiles_y * kp.tiles_x, kp.smem_bytes, kp.threads, stream)
    if err != 0:
        raise RuntimeError(f"fused_region launch failed ({err}): "
                           f"{lib.region_error_string(err).decode()}")
    launches += 1
    variant_launches["region_tc_kernel" if kp.tensor_cores
                     else "region_kernel"] += 1
    return out
