"""Pipeline parallelism (`darknet_tpu/parallel/pipeline.py`) on torch:
the layer graph cut into contiguous stages balanced by BFLOPs, each
stage's params only on its device, micro-batches streaming through the
stages.  One process drives the devices: every stage's work is queued on
its device's stream without a host synchronisation, so stage s of
micro-batch m runs while stage s-1 takes micro-batch m+1.

Cross-stage dataflow comes from the graph: a cut at layer c carries
layer c-1's output (the sequential `cur`) plus every earlier output
still read at or after c (`crossing_set`: route, shortcut and
scale_channels back-references; yolov4's neck reaches ~60 layers back;
`stage_keys` adds layer c-1 itself where its back-references read
another tensor than `cur`).
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

Both also run one stage a rank over a grid of one axis that spans the
world (`mesh=`, `parallel/mesh.world_mesh`): a stage boundary is then an
exchange between two ranks (`ops/collective`), the activation and the
tensors that cross the cut sent forward, their cotangents back.

A cut right after a back-referenced antialiased layer hands the next
stage both of that layer's outputs: the blurred tensor as the
activation, the stride-1 view as the layer's output (`stage_keys`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from darknet_tpu_torch.nn.emit import _aa_backref_needed, make_forward
from darknet_tpu_torch.ops import collective
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


def stage_keys(graph, live, lo: int) -> tuple:
    """The outputs a stage that starts at layer `lo` receives besides the
    sequential activation: `crossing_set`, and layer lo-1 itself where it
    is a back-referenced antialiased layer (`nn/emit._aa_backref_needed`).
    Such a layer has two outputs: the next layer reads the blurred tensor
    (the activation), its back-references the stride-1 view, which then
    crosses the cut as an output of its own."""
    if not lo:
        return ()
    keys = crossing_set(graph, lo)
    if _aa_backref_needed(graph.layers[lo - 1], lo - 1, live):
        keys = sorted(keys + [lo - 1])
    return tuple(keys)


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


def _world_stages(devices, mesh):
    """(devices, the ranks of the stages, this rank's stage): over a world
    grid of one axis, one stage a rank in the axis' order (the stages'
    devices but this rank's are only named); else (devices, None, None)."""
    if mesh is None or not mesh.spans_world:
        return [torch.device(d) for d in devices], None, None
    if mesh is not None and devices is not None:
        raise ValueError("a pipeline takes devices or a world mesh")
    if len(mesh.shape) != 1:
        raise ValueError(f"a pipeline takes a mesh of one axis, got {mesh}")
    (axis,) = mesh.shape
    ranks = mesh.line(axis)
    return [mesh.devices[0]] * len(ranks), ranks, mesh.coords[axis]


class _Boundaries:
    """The stage boundaries of a pipeline: in one process (`stage` None)
    every stage runs here and what crosses a cut is copied to the next
    stage's device; over a world of stages this rank runs stage `stage`
    alone and a cut is an exchange with the neighbouring stage's rank
    (`ops/collective`)."""

    def _mine(self):
        """The stages this process runs, in order."""
        return range(len(self.stages)) if self.stage is None \
            else (self.stage,)

    def _hand(self, s, ts, grad=False):
        """Stage s's tensors that cross the next cut: kept for the next
        stage in one process; sent to its rank over a world (`grad`:
        differentiable where the tensor requires grad)."""
        if self.stage is None:
            return ts
        for t in ts:
            collective.send(t, self.ranks[s + 1],
                            grad=grad and t.requires_grad)
        return None

    def _take(self, s, held, leaf=False):
        """Stage s's input and the tensors that cross its cut, on its
        device: `held` (what `_hand` kept) copied there, or received from
        the rank of the stage before; `leaf`: as fresh leaves whose .grad
        the backward phase hands back."""
        dev = self.devices[s]
        if self.stage is None:
            return [_stage_leaf(t, dev) if leaf else
                    t.to(dev, non_blocking=True) for t in held]
        src = self.ranks[s - 1]
        return [_recv_leaf(src, dev) if leaf else collective.recv(src, dev)[0]
                for _k in range(1 + len(self.stages[s]["keys_in"]))]


class PipelineForward(_Boundaries):
    """Stage-partitioned serving forward.

    fn = PipelineForward(graph, params, devices); heads = fn(x)
    params: the port's torch params (any device); stage s holds the
    params of its layers (and any share_index owner they read), with the
    regions' step weights, on devices[s] alone.  x splits into
    `microbatches` chunks that stream through the stages; the activated
    heads come back in batch order on devices[0].  fuse_regions as in
    `make_forward` ("hybrid": the region kernel's prefix in stage 0).

    With `mesh`, a grid of one axis over the world (`parallel/mesh.
    world_mesh`), stage s runs on the rank at coordinate s and holds only
    its own params: every rank calls fn(x) with the batch (or at least
    its shape), stage 0 takes the micro-batches from it, each stage
    receives its input and the tensors that cross its cut from the stage
    before and sends its own on (`ops/collective`), each stage's heads go
    to stage 0's rank, and fn returns the heads there in batch order, and
    None on the other ranks."""

    def __init__(self, graph, params, devices=None, *, compute_dtype=None,
                 fused_bn: bool = True, fuse_regions="hybrid",
                 microbatches: int = 2, mesh=None):
        from darknet_tpu_torch.nn.emit import ACTIVATE

        self.fwd = fwd = make_forward(graph, compute_dtype=compute_dtype,
                                      fused_bn=fused_bn,
                                      fuse_regions=fuse_regions)
        devices, self.ranks, self.stage = _world_stages(devices, mesh)
        n_stages = len(devices)
        forb = _forbidden_cuts(graph, fuse_regions=bool(fwd.region_plans),
                               stem_s2d=fwd.stem, fwd=fwd)
        self.cuts = plan_cuts(graph, n_stages, forbidden=forb)
        bounds = [0] + self.cuts + [len(graph.layers)]
        self.devices = devices
        self.microbatches = microbatches
        self.graph = graph
        held = fwd.with_step_weights(list(params))
        self.stages = []
        for s in range(n_stages):
            lo, hi = bounds[s], bounds[s + 1]
            needed = set(range(lo, hi)) if self.stage in (None, s) else set()
            for l in graph.layers[lo:hi] if needed else ():
                if (l.kind == "convolutional"
                        and getattr(l, "share_index", None) is not None):
                    needed.add(l.share_index)
            self.stages.append({
                "lo": lo, "hi": hi,
                "keys_in": stage_keys(graph, fwd.live, lo),
                "n_heads": sum(1 for l in graph.layers[lo:hi]
                               if l.kind in ACTIVATE),
                "params": [to_device(p, self.devices[s]) if i in needed
                           else {} for i, p in enumerate(held)]})

    def _micro(self, x) -> list:
        """One micro-batch through this process's stages: their heads in
        order (over a world, stage 0's own; the other stages send theirs
        to stage 0's rank)."""
        heads, held = [], None
        for s in self._mine():
            st = self.stages[s]
            lo, hi = st["lo"], st["hi"]
            if s:
                cur, *ext = self._take(s, held)
            else:
                cur, ext = x.to(self.devices[0], non_blocking=True), []
            extern = dict(zip(st["keys_in"], ext))
            if lo:
                extern.setdefault(lo - 1, cur)
            r = self.fwd(st["params"], cur, _lo=lo, _hi=hi, _extern=extern)
            if s + 1 < len(self.stages):
                held = self._hand(s, [r["output"]] + [
                    r["outs"][k] for k in self.stages[s + 1]["keys_in"]])
            if self.stage:
                for h in r["heads"]:
                    collective.send(h, self.ranks[0])
            else:
                heads.extend(r["heads"])
        return heads

    def __call__(self, x) -> list:
        x = torch.as_tensor(x)
        m = max(1, min(self.microbatches, x.shape[0]))
        chunks = [c for c in np.array_split(np.arange(x.shape[0]), m)
                  if len(c)]
        with torch.inference_mode():
            try:
                outs = [self._micro(x[c[0]:c[-1] + 1]) for c in chunks]
                if self.stage:
                    return None
                if self.stage == 0:
                    for o in outs:
                        for t in range(1, len(self.stages)):
                            o.extend(collective.recv(self.ranks[t],
                                                     self.devices[0])[0]
                                     for _h in range(
                                         self.stages[t]["n_heads"]))
            finally:
                if self.stage is not None:
                    collective.flush()
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


class PipelineTrain(_Boundaries):
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
    host synchronisation happens inside a step.

    With `mesh`, a grid of one axis over the world (`parallel/mesh.
    world_mesh`), stage s runs on the rank at coordinate s and holds only
    its params, grads and slots; every rank calls step(x, truths, lr) with
    the whole batch.  The crossing tensors go to the next stage's rank
    and their cotangents come back (`ops/collective`); each rank takes the
    micro-batches in the one-process order, forward phase then backward
    phase, so every sum keeps its order; the heads' costs and metrics are
    shared among the ranks, which all return the same (cost, metrics).
    With a generator (every rank passing one in the same state), its
    state travels with the activation across each cut and from the last
    stage back to stage 0 for the next micro-batch, so the random layers
    draw the unsliced forward's masks; the step leaves every rank's
    generator in the state the one-process step leaves it (the forward
    phase then runs one stage at a time)."""

    def __init__(self, graph, params, devices=None, *, microbatches: int = 2,
                 compute_dtype=None, train_act_dtype=None, iter0: int = 0,
                 mesh=None):
        from darknet_tpu_torch.nn.emit import HEAD_KINDS
        from darknet_tpu_torch.train.step import init_opt_state

        self.graph = graph
        self.microbatches = microbatches
        self.compute_dtype = compute_dtype
        self.devices, self.ranks, self.stage = _world_stages(devices, mesh)
        self.group = None if mesh is None else mesh.group
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
            needed = set(range(lo, hi)) if self.stage in (None, s) else set()
            for l in graph.layers[lo:hi] if needed else ():
                if (l.kind == "convolutional"
                        and getattr(l, "share_index", None) is not None):
                    needed.add(l.share_index)
            p_s = leaf_copies(graph, params, dev, needed)
            self.stages.append({
                "lo": lo, "hi": hi,
                "keys_in": stage_keys(graph, self.fwd.live, lo),
                "heads": [graph.layers[i] for i in heads if lo <= i < hi],
                "first_head": sum(1 for i in heads if i < lo),
                "params": p_s,
                "opt": init_opt_state(graph, p_s, iter0=iter0)})

    # --------------------------------------------- the generator's state
    def _passes_generator(self, generator) -> bool:
        return (generator is not None and self.stage is not None
                and len(self.stages) > 1)

    def _generator_in(self, s, m, generator) -> None:
        """Over a world: stage s of micro-batch m takes the generator's
        state from the stage before (stage 0 of a later micro-batch from
        the last stage)."""
        if not self._passes_generator(generator) or not (s or m):
            return
        src = self.ranks[s - 1] if s else self.ranks[-1]
        generator.set_state(collective.recv(src, "cpu")[0])

    def _generator_out(self, s, m, n_micro, generator) -> None:
        """Over a world: stage s hands the generator's state on after
        micro-batch m; after the forward phase the last stage's state
        goes to every rank."""
        if not self._passes_generator(generator):
            return
        last = len(self.stages) - 1
        if s < last:
            collective.send(generator.get_state(), self.ranks[s + 1])
        elif m + 1 < n_micro:
            collective.send(generator.get_state(), self.ranks[0])
        if m + 1 == n_micro:
            if s == last:
                for r in self.ranks[:-1]:
                    collective.send(generator.get_state(), r)
            else:
                generator.set_state(collective.recv(self.ranks[-1],
                                                    "cpu")[0])

    # -------------------------------------------------------------- step
    def _forward(self, xj, generator, m, n_micro) -> list:
        """Micro-batch m through this process's stages: a record a stage
        (its input leaves, its outputs that cross the next cut, raw heads,
        batch statistics), None for another rank's stage."""
        last = len(self.stages) - 1
        recs, held = [None] * len(self.stages), None
        for s in self._mine():
            st = self.stages[s]
            if s:
                cur, *ext = self._take(s, held, leaf=True)
                ext = dict(zip(st["keys_in"], ext))
            else:
                cur, ext = xj.to(self.devices[0], non_blocking=True), {}
            self._generator_in(s, m, generator)
            extern = dict(ext)
            if st["lo"]:
                extern.setdefault(st["lo"] - 1, cur)
            r = self.fwd(st["params"], cur, generator, _lo=st["lo"],
                         _hi=st["hi"], _extern=extern)
            rec = {"cur_in": cur, "ext_in": ext, "raws": r["raw_heads"],
                   "stats": r["bn_stats"]}
            if s < last:
                rec["out"] = r["output"]
                rec["ext_out"] = {k: r["outs"][k]
                                  for k in self.stages[s + 1]["keys_in"]}
                held = self._hand(s, [rec["out"], *rec["ext_out"].values()],
                                  grad=True)
            self._generator_out(s, m, n_micro, generator)
            recs[s] = rec
        return recs

    def _cotangents(self, s, rec, nxt) -> list:
        """The cotangents of stage s's crossing outputs (None where none
        came): the next stage's leaves' .grad copied to its device, or
        received from the next stage's rank."""
        dev = self.devices[s]
        if self.stage is None:
            return [None if leaf.grad is None else
                    leaf.grad.to(dev, non_blocking=True)
                    for leaf in [nxt["cur_in"], *nxt["ext_in"].values()]]
        return [_recv_cotangent(self.ranks[s + 1], dev)
                for _t in range(1 + len(rec["ext_out"]))]

    def _hand_back(self, s, rec) -> None:
        """Over a world: stage s's leaves' cotangents to the stage
        before's rank (an empty tensor for a leaf that took none)."""
        if self.stage is None or not s:
            return
        for leaf in [rec["cur_in"], *rec["ext_in"].values()]:
            collective.send(leaf.grad if leaf.grad is not None
                            else torch.empty(0), self.ranks[s - 1])

    def _heads_by_micro(self, mine) -> tuple:
        """(costs, metrics) a micro-batch over every head in graph order,
        on devices[0], from this process's {head: (cost, metrics)} a
        micro-batch (over a world, every rank's, shared)."""
        home = self.devices[0]
        if self.stage is not None:
            mine = [{h: (c.cpu(), {n: v.cpu() for n, v in met.items()})
                     for h, (c, met) in per.items()} for per in mine]
            shared = [None] * len(self.ranks)
            dist.all_gather_object(shared, mine, group=self.group)
            mine = [{h: v for per_rank in shared for h, v in
                     per_rank[m].items()} for m in range(len(mine))]
        costs, mets = [], []
        for by_head in mine:
            costs.append(torch.stack([by_head[h][0].to(home, non_blocking=True)
                                      for h in range(self.n_heads)]).sum())
            mets.append([{n: v.to(home, non_blocking=True)
                          for n, v in by_head[h][1].items()}
                         for h in range(self.n_heads)])
        return costs, mets

    def step(self, x, truths, lr, generator=None):
        """One optimizer step over the whole batch; returns (cost,
        metrics) on devices[0].  Params and slots stay on their stages."""
        try:
            return self._step(x, truths, lr, generator)
        finally:
            if self.stage is not None:
                collective.flush()

    def _step(self, x, truths, lr, generator):
        from darknet_tpu_torch.train import step as stepmod

        graph, net = self.graph, self.graph.net
        last = len(self.stages) - 1
        mine = self._mine()
        x, truths = torch.as_tensor(x), torch.as_tensor(truths)
        for s in mine:
            stepmod.zero_grads(self.stages[s]["params"])
        micro = stepmod.micro_batches(x, truths, self.microbatches)
        recs = [self._forward(xj, generator, m, len(micro))
                for m, (xj, _tj) in enumerate(micro)]
        heads, stats = [], [[] for _ in self.stages]
        for m, (_xj, tj) in enumerate(micro):
            by_head = {}
            for s in reversed(mine):
                st, rec, dev = self.stages[s], recs[m][s], self.devices[s]
                c_s, met_s, roots, cts = stepmod.head_deltas(
                    rec["raws"], st["heads"], tj.to(dev, non_blocking=True),
                    net, first=st["first_head"])
                for k, (c, met) in enumerate(zip(c_s, met_s)):
                    by_head[st["first_head"] + k] = (c, met)
                if s < last:
                    outs = [rec["out"], *rec["ext_out"].values()]
                    _add_cotangents(roots, cts, zip(
                        outs, self._cotangents(s, rec, recs[m][s + 1])))
                cost_s = torch.stack(c_s).sum() if c_s else None
                stepmod.backward(roots, cts, self.compute_dtype, cost_s)
                self._hand_back(s, rec)
                stats[s].append(rec["stats"])
                recs[m][s + 1:] = [None] * (last - s)
            recs[m] = None
            heads.append(by_head)
        costs, mets = self._heads_by_micro(heads)
        cost, metrics = stepmod.summarize(costs, mets, self.n_heads)
        for s in mine:
            st = self.stages[s]
            stepmod.finish_step(graph, st["params"], st["opt"], lr, cost)
            stepmod.roll_bn_stats(st["params"], stats[s])
        return cost, metrics

    def gather_params(self) -> list:
        """Every stage's params merged into one params list (detached, on
        devices[0]), for checkpointing through `weights/io` or serving;
        over a world of stages, on every rank (each stage's params travel
        through the host once)."""
        device = self.devices[0]
        full = [{} for _ in self.graph.layers]
        if self.stage is not None:
            own = {i: {k: v.detach().cpu() for k, v in p.items()}
                   for i, p in enumerate(self.stages[self.stage]["params"])
                   if p}
            every = [None] * len(self.ranks)
            dist.all_gather_object(every, own, group=self.group)
            for own in every:
                for i, p in own.items():
                    if not full[i]:
                        full[i] = {k: v.to(device) for k, v in p.items()}
            return full
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


def _recv_leaf(src, dev):
    """A tensor that crosses a cut from the rank of the stage before, as a
    fresh leaf (requiring grad where the sender's tensor does)."""
    t, _tag, grad = collective.recv(src, dev)
    return t.requires_grad_(grad)


def _recv_cotangent(src, dev):
    """The cotangent of a crossing tensor from the next stage's rank, or
    None where its leaf took none (sent as an empty tensor)."""
    g = collective.recv(src, dev)[0]
    return None if g.dim() == 1 and g.numel() == 0 else g


def _add_cotangents(roots, cts, pairs) -> None:
    """Extend the backward's roots with each (output, its cotangent or
    None) pair's output; an output that is already a root (two keys
    naming one tensor) adds to its cotangent."""
    at = {id(r): n for n, r in enumerate(roots)}
    for out, g in pairs:
        if g is None or not out.requires_grad:
            continue
        n = at.get(id(out))
        if n is None:
            at[id(out)] = len(roots)
            roots.append(out)
            cts.append(g)
        else:
            cts[n] = cts[n] + g
