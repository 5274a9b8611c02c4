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

`PipelineTrain` is GPipe training over the same cuts with the training
rule (no region, `_forbidden_cuts(train=True)`), the stages' params,
grads and optimizer slots each on its stage's device.
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


def _forbidden_cuts(graph, *, fuse_regions, stem_s2d, train=False,
                    fwd=None) -> set:
    """Cut positions that would split the stem fold, a region (the plans
    `fwd` runs where given, else those `plan_graph_regions` makes) or a
    weight-shared conv from its owner.  train=True is the training
    forward's rule: it plans no region (the JAX package plans training
    regions only on a TPU, `darknet_tpu/parallel/pipeline.py:88-112`
    with fuse_regions False elsewhere), so only the weight-shared spans
    are forbidden."""
    out = set()
    if stem_s2d:
        out.add(1)                    # the s2d stem folds layers 0-1
    if train:
        fuse_regions, fwd = False, None
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


def leaf_copies(graph, params, device, keep=None) -> list:
    """Fresh training leaves on `device` of the port's training params
    (torch, `nn/params.train_params_to_torch`'s layout, any device) or of
    unfolded numpy params: "w", "b" and "scales" require grad; layers not
    in `keep` (None: every layer) get {}.  Never the caller's tensors: the
    executors update their leaves in place."""
    from darknet_tpu_torch.nn import params as paramlib

    device = torch.device(device)
    if not any(isinstance(v, torch.Tensor) for p in params
               for v in p.values()):
        params = paramlib.train_params_to_torch(graph, params, "cpu")
    out = []
    for i, p in enumerate(params):
        if keep is not None and i not in keep:
            out.append({})
            continue
        q = {}
        for k, v in p.items():
            t = torch.empty_strided(v.shape, v.stride(), dtype=v.dtype,
                                    device=device)
            with torch.no_grad():
                t.copy_(v)
            q[k] = t.requires_grad_(k in paramlib.TRAINABLE)
        out.append(q)
    return out


class PipelineTrain:
    """GPipe pipeline training over the stage split
    (`darknet_tpu/parallel/pipeline.py:201-448`), one process driving
    every stage's device.

    pt = PipelineTrain(graph, params, devices, microbatches=M)
    cost, metrics = pt.step(x, truths, lr, generator=None)
    params = pt.gather_params()

    Stage s holds only its layers' params (a weight-shared conv lives in
    its owner's stage, `_forbidden_cuts`), their grads and their SGD or
    Adam slots, all on devices[s]; the cuts are `plan_cuts` with the
    training rule (no region).  A step equals `train/step.
    make_train_step(accum=M)` on the whole batch:

    * micro-batch j takes images j, j + M, ... (the interleaved split);
    * forward phase: micro-batch after micro-batch, stage after stage,
      each stage the training forward in stage-slice mode
      (`nn/emit._make_train_forward`'s _lo/_hi/_extern); the tensors that
      cross a cut (layer c-1's output and `crossing_set`'s back-
      references, carried through intermediate stages as identities)
      are copied to the next stage's device, where they enter as fresh
      leaves.  The random layers draw in the unsliced forward's order;
    * backward phase: micro-batch after micro-batch, stages in reverse
      order: each stage computes its own heads' deltas on its device
      (`train/step.head_deltas`, the truths copied there) and runs its
      backward from them and from the cotangents that the next stage's
      leaves received, copied back; a carried tensor's cotangent adds to
      its local uses' on the stage that holds it;
    * update phase: each stage's optimizer on its own params
      (`train/step.optimizer_update`) and its rolling statistics from
      each micro-batch's batch statistics in sequence (keep 0.9^M, weight
      0.1 * 0.9^(M-1-j) for micro-batch j, `train/step.roll_bn_stats`);
    * the cost and the metrics as `make_train_step(accum=M)` forms them
      (`train/step.summarize`), the heads indexed over the whole graph.

    The JAX package recomputes each stage inside `jax.vjp` in the
    backward phase (GPipe's memory profile); this class keeps each
    micro-batch's stage graphs from the forward phase instead, so the
    random layers draw once and the numbers are the same (a standing
    deviation, ROADMAP).  Copies between devices are asynchronous, and no
    host synchronisation happens inside a step."""

    def __init__(self, graph, params, devices, *, microbatches: int = 2,
                 compute_dtype=None, train_act_dtype=None, iter0: int = 0):
        from darknet_tpu_torch.nn.emit import HEAD_KINDS
        from darknet_tpu_torch.train.step import init_opt_state

        self.graph = graph
        self.microbatches = microbatches
        self.compute_dtype = compute_dtype
        self.devices = [torch.device(d) for d in devices]
        self.fwd = make_forward(graph, train=True,
                                compute_dtype=compute_dtype,
                                train_act_dtype=train_act_dtype)
        n = len(graph.layers)
        forb = _forbidden_cuts(graph, fuse_regions=False, stem_s2d=False,
                               train=True)
        self.cuts = plan_cuts(graph, len(self.devices), forbidden=forb)
        bounds = [0] + self.cuts + [n]
        heads = [i for i, l in enumerate(graph.layers)
                 if l.kind in HEAD_KINDS]
        self.n_heads = len(heads)
        self.stages = []
        for s, dev in enumerate(self.devices):
            lo, hi = bounds[s], bounds[s + 1]
            needed = set(range(lo, hi))
            for l in graph.layers[lo:hi]:
                if (l.kind == "convolutional"
                        and getattr(l, "share_index", None) is not None):
                    needed.add(l.share_index)
            p_s = leaf_copies(graph, params, dev, needed)
            self.stages.append({
                "lo": lo, "hi": hi,
                "keys_in": tuple(crossing_set(graph, lo) if lo else ()),
                "heads": [graph.layers[i] for i in heads if lo <= i < hi],
                "first_head": sum(1 for i in heads if i < lo),
                "params": p_s,
                "opt": init_opt_state(graph, p_s, iter0=iter0)})

    def _forward(self, x, generator):
        """One micro-batch through every stage: a record a stage (its
        input leaves, its outputs that cross the next cut, raw heads,
        batch statistics)."""
        recs, cur, ext = [], x, {}
        last = len(self.stages) - 1
        for s, st in enumerate(self.stages):
            dev = self.devices[s]
            if s:
                cur = _stage_leaf(cur, dev)
                ext = {k: _stage_leaf(v, dev) for k, v in ext.items()}
            extern = dict(ext)
            if st["lo"]:
                extern[st["lo"] - 1] = cur
            r = self.fwd(st["params"], cur, generator, _lo=st["lo"],
                         _hi=st["hi"], _extern=extern)
            rec = {"cur_in": cur, "ext_in": ext, "raws": r["raw_heads"],
                   "stats": r["bn_stats"]}
            if s < last:
                rec["out"] = r["output"]
                rec["ext_out"] = {k: r["outs"][k]
                                  for k in self.stages[s + 1]["keys_in"]}
                cur, ext = rec["out"], rec["ext_out"]
            recs.append(rec)
        return recs

    def step(self, x, truths, lr, generator=None):
        """One optimizer step over the whole batch; returns (cost,
        metrics) on devices[0].  Params and slots stay on their stages."""
        from darknet_tpu_torch.train import step as stepmod

        graph, net = self.graph, self.graph.net
        home = self.devices[0]
        x, truths = torch.as_tensor(x), torch.as_tensor(truths)
        for st in self.stages:
            stepmod.zero_grads(st["params"])
        micro = stepmod.micro_batches(x, truths, self.microbatches)
        recs = [self._forward(xj.to(home, non_blocking=True), generator)
                for xj, _tj in micro]
        costs, mets, stats = [], [], [[] for _ in self.stages]
        for m, (_xj, tj) in enumerate(micro):
            c_m, m_m = [None] * self.n_heads, [None] * self.n_heads
            for s in range(len(self.stages) - 1, -1, -1):
                st, rec, dev = self.stages[s], recs[m][s], self.devices[s]
                c_s, met_s, roots, cts = stepmod.head_deltas(
                    rec["raws"], st["heads"], tj.to(dev, non_blocking=True),
                    net, first=st["first_head"])
                for k, (c, met) in enumerate(zip(c_s, met_s)):
                    c_m[st["first_head"] + k] = c.to(home, non_blocking=True)
                    m_m[st["first_head"] + k] = {
                        n: v.to(home, non_blocking=True)
                        for n, v in met.items()}
                if s + 1 < len(self.stages):
                    nxt = recs[m][s + 1]
                    pairs = [(rec["out"], nxt["cur_in"])] + [
                        (rec["ext_out"][k], nxt["ext_in"][k])
                        for k in rec["ext_out"]]
                    _add_cotangents(roots, cts, pairs, dev)
                cost_s = torch.stack(c_s).sum() if c_s else None
                stepmod.backward(roots, cts, self.compute_dtype, cost_s)
                stats[s].append(rec["stats"])
                recs[m][s + 1:] = [None] * (len(self.stages) - s - 1)
            recs[m] = None
            costs.append(torch.stack(c_m).sum())
            mets.append(m_m)
        cost, metrics = stepmod.summarize(costs, mets, self.n_heads)
        for s, st in enumerate(self.stages):
            stepmod.finish_step(graph, st["params"], st["opt"], lr, cost)
            stepmod.roll_bn_stats(st["params"], stats[s])
        return cost, metrics

    def gather_params(self) -> list:
        """Every stage's params merged into one params list (detached, on
        devices[0]), for checkpointing through `weights/io` or serving."""
        device = self.devices[0]
        full = [{} for _ in self.graph.layers]
        for st in self.stages:
            for i, p in enumerate(st["params"]):
                if p and not full[i]:
                    full[i] = {k: v.detach().to(device) for k, v in p.items()}
        return full


def _stage_leaf(t, dev):
    """A tensor that crosses a cut, on the next stage's device as a fresh
    leaf (requiring grad where `t` does), whose .grad the backward phase
    hands back to the stage that produced `t`."""
    return t.to(dev, non_blocking=True).detach().requires_grad_(
        t.requires_grad)


def _add_cotangents(roots, cts, pairs, dev) -> None:
    """Extend the backward's roots with each (output, next stage's leaf)
    pair's output and the leaf's .grad copied to `dev`; an output that
    is already a root (two keys naming one tensor) adds to its
    cotangent."""
    at = {id(r): n for n, r in enumerate(roots)}
    for out, leaf in pairs:
        if leaf.grad is None or not out.requires_grad:
            continue
        g = leaf.grad.to(dev, non_blocking=True)
        n = at.get(id(out))
        if n is None:
            at[id(out)] = len(roots)
            roots.append(out)
            cts.append(g)
        else:
            cts[n] = cts[n] + g
