"""Pipeline parallelism (`darknet_tpu/parallel/pipeline.py`) on torch:
the layer graph cut into contiguous stages balanced by BFLOPs, each
stage's params only on its device, micro-batches streaming through the
stages.  One process drives the devices: every stage's work is queued on
its device's stream without a host synchronisation, so stage s of
micro-batch m runs while stage s-1 takes micro-batch m+1.

Cross-stage dataflow comes from the graph: a cut at layer c carries
layer c-1's output (the sequential `cur`) plus every earlier output
still read at or after c (`crossing_set`: route, shortcut and
scale_channels back-references; yolov4's neck reaches ~60 layers back).
Each stage runs the serving forward in stage-slice mode
(`nn/emit.make_forward`'s _lo/_hi/_extern), so every layer kind runs as
in the unsharded forward.

The stem fold stays on, in stage 0: without it yolov4's only region
(layers 1-23) has no stride-1 kernel prefix, and the path would launch
no region kernel.  A region is never cut (`_forbidden_cuts`).  The JAX
package turns the fold off for its per-layer cut bookkeeping; its cut
rule on the TPU, `plan_cuts(graph, n, forbidden=_forbidden_cuts(graph,
fuse_regions=True, stem_s2d=False))`, is this module's too.

A dynamic int8 scale is each micro-batch's own, as the JAX package's
separately jitted micro-batches take it.
"""

from __future__ import annotations

import numpy as np
import torch

from darknet_tpu_torch.nn.emit import make_forward
from darknet_tpu_torch.parallel.mesh import to_device


def consumed(layer, i: int) -> list:
    """Graph indices layer i reads: routes consume exactly their listed
    layers; everything else implicitly consumes i-1 plus any extra edges
    (shortcut/scale_channels from_layer)."""
    if layer.kind == "route":
        return list(layer.input_indices())
    return ([i - 1] if i > 0 else []) + list(layer.input_indices())


def crossing_set(graph, cut: int) -> list:
    """Sorted indices j < cut-1 whose outputs are consumed at/after cut
    (cut-1 travels as the sequential activation)."""
    need = set()
    for i in range(cut, len(graph.layers)):
        for s in consumed(graph.layers[i], i):
            if 0 <= s < cut:
                need.add(s)
    need.discard(cut - 1)
    return sorted(need)


def plan_cuts(graph, n_stages: int, *, forbidden=()) -> list:
    """Stage boundaries [c_1..c_{S-1}] balancing cumulative BFLOPs,
    snapped away from `forbidden` positions (region interiors)."""
    bf = np.array([l.bflops or 0.0 for l in graph.layers])
    cum = np.cumsum(bf)
    total = cum[-1] if len(cum) else 0.0
    forbidden = set(forbidden)
    n = len(graph.layers)
    cuts = []
    for s in range(1, n_stages):
        target = total * s / n_stages
        c = int(np.searchsorted(cum, target)) + 1
        # every candidate is > the previous cut and outside `forbidden`:
        # snap forward first, then backward
        lo = cuts[-1] + 1 if cuts else 1
        c = max(lo, min(c, n - 1))
        fwd = c
        while fwd in forbidden and fwd < n - 1:
            fwd += 1
        if fwd not in forbidden:
            c = fwd
        else:
            bwd = c
            while bwd in forbidden and bwd > lo:
                bwd -= 1
            if bwd in forbidden:
                raise ValueError(
                    f"pipeline stage {s}: no legal cut in [{lo}, {n - 1}] — "
                    f"every position is inside a fused region or "
                    f"share_index span; reduce n_stages or disable fusion")
            c = bwd
        cuts.append(c)
    return cuts


def _forbidden_cuts(graph, *, fuse_regions, stem_s2d, fwd=None) -> set:
    """Cut positions that would split the stem fold, a region (the plans
    `fwd` runs where given, else those `plan_graph_regions` makes) or a
    weight-shared conv from its owner."""
    out = set()
    if stem_s2d:
        out.add(1)                    # the s2d stem folds layers 0-1
    if fwd is not None and getattr(fwd, "region_plans", None) is not None:
        for a, pl in fwd.region_plans.items():
            out.update(range(a + 1, pl.stop + 1))
    elif fuse_regions:
        from darknet_tpu_torch.ops.fused_region import plan_graph_regions

        for a, pl in plan_graph_regions(graph, stem=stem_s2d).items():
            out.update(range(a + 1, pl.stop + 1))
    # a weight-shared conv (share_index) lives in its owner's stage
    for i, l in enumerate(graph.layers):
        s = getattr(l, "share_index", None)
        if l.kind == "convolutional" and s is not None:
            out.update(range(s + 1, i + 1))
    return out


class PipelineForward:
    """Stage-partitioned serving forward.

    fn = PipelineForward(graph, params, devices); heads = fn(x)
    params: the port's torch params (any device); stage s holds the
    params of its layers (and any share_index owner they read), with the
    regions' step weights, on devices[s] alone.  x splits into
    `microbatches` chunks that stream through the stages; the activated
    heads come back in batch order on devices[0].  fuse_regions as in
    `make_forward` ("hybrid": the region kernel's prefix in stage 0)."""

    def __init__(self, graph, params, devices, *, compute_dtype=None,
                 fused_bn: bool = True, fuse_regions="hybrid",
                 microbatches: int = 2):
        self.fwd = fwd = make_forward(graph, compute_dtype=compute_dtype,
                                      fused_bn=fused_bn,
                                      fuse_regions=fuse_regions)
        n_stages = len(devices)
        forb = _forbidden_cuts(graph, fuse_regions=bool(fwd.region_plans),
                               stem_s2d=fwd.stem, fwd=fwd)
        self.cuts = plan_cuts(graph, n_stages, forbidden=forb)
        bounds = [0] + self.cuts + [len(graph.layers)]
        self.devices = [torch.device(d) for d in devices]
        self.microbatches = microbatches
        held = fwd.with_step_weights(list(params))
        self.stages = []
        for s in range(n_stages):
            lo, hi = bounds[s], bounds[s + 1]
            needed = set(range(lo, hi))
            for l in graph.layers[lo:hi]:
                if (l.kind == "convolutional"
                        and getattr(l, "share_index", None) is not None):
                    needed.add(l.share_index)
            self.stages.append({
                "lo": lo, "hi": hi,
                "keys_in": tuple(crossing_set(graph, lo) if lo else []),
                "keys_out": tuple(crossing_set(graph, hi)
                                  if hi < len(graph.layers) else []),
                "params": [to_device(p, self.devices[s]) if i in needed
                           else {} for i, p in enumerate(held)]})

    def _run_micro(self, x) -> list:
        cur, ext = x, ()
        heads = []
        for s, st in enumerate(self.stages):
            dev = self.devices[s]
            cur = cur.to(dev, non_blocking=True)
            ext = tuple(e.to(dev, non_blocking=True) for e in ext)
            lo, hi = st["lo"], st["hi"]
            extern = dict(zip(st["keys_in"], ext))
            if lo:
                extern[lo - 1] = cur
            r = self.fwd(st["params"], cur, _lo=lo, _hi=hi, _extern=extern)
            # re-key: the next stage's keys_in come from this stage's
            # outputs or are carried through
            nxt = self.stages[s + 1]["keys_in"] \
                if s + 1 < len(self.stages) else ()
            ext = tuple(r["outs"][k] for k in nxt)
            cur = r["output"]
            heads.extend(r["heads"])
        return heads

    def __call__(self, x) -> list:
        x = torch.as_tensor(x)
        m = max(1, min(self.microbatches, x.shape[0]))
        chunks = np.array_split(np.arange(x.shape[0]), m)
        with torch.inference_mode():
            outs = [self._run_micro(x[c[0]:c[-1] + 1].to(self.devices[0]))
                    for c in chunks if len(c)]
            home = self.devices[0]
            return [torch.cat([o[h].to(home) for o in outs])
                    for h in range(len(outs[0]))]
