"""Training orchestration, the TrainDetector equivalent (detector.cpp:
27-324): `DetectorTrainer` and `train_detector`
(`darknet_tpu/train/trainer.py:41-660`) on torch.

Reproduced behaviours:
* ``max_iter = iter_per_epoch * max_epoch`` with
  ``iter_per_epoch = round(num_train_imgs / optimizer_batch)``;
* multi-scale: every 10 iterations a random scale in [1/rand_coef,
  rand_coef] (rand_coef = 1.4 or the head's `random` value), snapped to
  `resize_step`, forced to the largest at the start (while the EMA loss is
  unset) and over the last 100 iterations; each (w, h) bucket rebuilds the
  graph through `config/cfg.patch_cfg_dims` and gets its own step;
* subdivisions as micro-batches of the step (`accum`);
* the EMA loss 0.9/0.1 and the reference's log line; `.weights` every
  1000 iterations and at the end, each with the full resumable state
  (`<save_name>_last.ckpt.npz`: params, optimizer slots, seen, the torch
  Generator state, EMA loss, best mAP, bucket, loss and mAP history);
  `resume=` restores it exactly, the loader's seed stream included;
* in-training mAP (calc_map with val_paths): from iteration
  max(burn_in, start) every ``map_step = max(100, iter_per_epoch)``
  iterations and at max_iter, on an inference copy of the weights
  (`evaluate_map`), with `<save_name>_best.weights` when it improves;
* SIGTERM/SIGINT finish the iteration, save, and return;
* `metric_lag`: iteration i's metrics are read once i + metric_lag steps
  have been queued, so the host does not wait for the card every step;
* dropout, dropblock and [crop] draw on the training device, from a
  generator seeded every step from the trainer's checkpointed CPU
  generator (`_step_generator`), never on the host.

The device is the CUDA card unless the caller passes device="cpu"
(without a card any other call raises).  On the card the defaults are the
JAX package's accelerator defaults: bf16 compute, act16 and metric_lag 3;
on the CPU f32, no act16 and metric_lag 0.

Batches go up through pinned staging buffers (`PinnedUploader`), and in
bf16 when the step computes in bf16 and layer 0 is a conv
(`_loader_out_dtype`): the conv casts its input to the compute dtype
first, so the host's cast is the same bits and the copy half the bytes.
`show_imgs=N` writes N augmented samples a batch to save_dir
(`data/augment.save_augmented_sample`).

The loss/mAP chart is drawn to `<save_dir>/chart.png` every 10th
iteration, at each mAP and at the end (`apps/visualize.draw_loss_chart`).

Data parallelism (`mesh=`, `darknet_tpu/train/trainer.py:248-256,
358-374,412-418,497-508`): one trainer a process, each on its rank's
device of a mesh made under `torch.distributed` (`parallel/mesh.
make_mesh`, started by `parallel/multihost.spawn`).  Each rank's loader
builds only its block of every global batch (`DetectionLoader(rows=)`),
the step is `parallel/dp.make_dp_train_step` (sync-BN, one gradient sum a
step), so every rank holds the same params; every iteration the ranks
agree on a stop (a signal to one stops all at the same boundary); rank 0
alone logs, draws the chart and writes `.weights`; the resumable state is
the sharded directory (`train/checkpoint.save_checkpoint_sharded`), which
every rank writes its part of; the in-training mAP rides the mesh.  The
random layers of rank r draw from the step's seed + r, so their masks
are not the single-process run's.  Model-parallel training runs through
the steps of `parallel/pipeline.PipelineTrain`, `parallel/tensor.
make_tp_train_step` (with `sp_axis` the (dp, sp, tp) step) and
`parallel/spatial.make_spatial_train_step`, in one process that drives
every device of a mesh or over a grid that spans the world, one process
a device (`parallel/mesh.world_mesh`); the trainer does not drive them.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from darknet_tpu_torch.data.loader import DetectionLoader
from darknet_tpu_torch.graph.builder import build_graph
from darknet_tpu_torch.nn import params as paramlib
from darknet_tpu_torch.train import checkpoint as ck
from darknet_tpu_torch.train.schedule import get_lr
from darknet_tpu_torch.train.step import init_opt_state, make_train_step
from darknet_tpu_torch.weights import io as wio


class PinnedUploader:
    """Host batches to `device` through two pinned staging buffers used in
    turn, so that a non_blocking copy really runs asynchronously (a copy
    from pageable memory waits for the host).  A buffer is refilled only
    once the copy that last read it has finished: an event recorded
    after each copy is waited on first.  The buffers follow the batch's
    shape and dtype (the multi-scale bucket) and are made anew when it
    changes.  On the CPU nothing is pinned: the batch passes through."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._slots: list = []           # [buffer, event after its copy]
        self._turn = 0
        self.bytes = 0                   # bytes uploaded so far

    def __call__(self, batch) -> torch.Tensor:
        t = torch.as_tensor(batch)
        self.bytes += t.numel() * t.element_size()
        if self.device.type != "cuda":
            return t.to(self.device)
        if not self._slots or self._slots[0][0].shape != t.shape or \
                self._slots[0][0].dtype != t.dtype:
            for _buf, ev in self._slots:
                if ev is not None:
                    ev.synchronize()
            self._slots = [[torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True), None]
                           for _ in range(2)]
        slot = self._slots[self._turn]
        self._turn ^= 1
        if slot[1] is not None:
            slot[1].synchronize()
        slot[0].copy_(t)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out


class DetectorTrainer:
    def __init__(self, cfg, train_paths, *, weights=None, classes=80,
                 clear=False, mesh=None, compute_dtype=None, seed=0,
                 calc_map=False, val_paths=None, save_dir="backup",
                 save_name="model", loader_threads=6, loader_processes=-1,
                 log=print, metrics_path=None, show_imgs=0, remat=False,
                 act16=None, resume=False,
                 metric_lag=None, device="cuda"):
        self.device = paramlib.resolve_device(device)
        self.mesh = mesh
        self.rank, self.world = 0, 1
        if mesh is not None:
            if mesh.group is None and mesh.shape["dp"] > 1:
                raise ValueError(
                    f"training on {mesh} needs one process a device (a "
                    f"mesh made under torch.distributed)")
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"device={device!r} but the mesh's device "
                                 f"is {mesh.devices[0]}")
            self.device = mesh.devices[0]
            self.rank, self.world = mesh.rank, mesh.shape["dp"]
            if self.rank:
                log, metrics_path = (lambda *_a, **_k: None), None
        on_card = self.device.type == "cuda"
        self.graph = build_graph(cfg, train=True)
        self.net = self.graph.net
        # keep the cfg as TEXT so multi-scale rebuilds can patch dims
        if isinstance(cfg, str) and "\n" not in cfg:
            with open(cfg, "r") as f:
                self.cfg = f.read()
        else:
            self.cfg = cfg
        if compute_dtype is None and on_card:
            compute_dtype = torch.bfloat16
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.act16 = on_card if act16 is None else act16
        if metric_lag is None:
            metric_lag = 3 if on_card else 0
        self.metric_lag = max(int(metric_lag), 0)
        self.log = log
        self.save_dir = save_dir
        self.save_name = save_name
        self.calc_map = calc_map
        self.val_paths = val_paths or []
        self.classes = classes

        self.seen = 0
        init = paramlib.init_params(self.graph, seed=seed)
        if weights is not None:
            loaded, self.seen, _ = wio.load_weights(self.graph, weights)
            init = [p if p else i for p, i in zip(loaded, init)]
        if clear:
            self.seen = 0
        self.params = paramlib.train_params_to_torch(self.graph, init,
                                                     self.device)
        # the update gates' iteration counter starts from seen
        self.opt_state = init_opt_state(self.graph, self.params,
                                        iter0=self.curr_iter)

        # the JAX package's PRNG key, checkpointed with the rest: each
        # step's dropout, dropblock and crop draw from a generator on the
        # training device seeded from it (`_step_generator`)
        self._gen = torch.Generator().manual_seed(0)
        self._avg_loss = -1.0
        self._best_map = 0.0
        self._dims = None
        self._chart = {"iters": [], "losses": [], "map_iters": [],
                       "maps": []}
        self._map_net = None
        self.state_path = os.path.join(save_dir,
                                       f"{save_name}_last.ckpt.npz")
        if self.world > 1:
            # the sharded state is a directory
            self.state_path = self.state_path[:-len(".npz")]

        heads = self.graph.heads()
        self.head = heads[-1] if heads else None
        self.max_boxes = getattr(self.head, "max_boxes", 90)
        self.jitter = getattr(self.head, "jitter", 0.3)
        self.random_coef = getattr(self.head, "random", 0.0)

        n_imgs = len(train_paths)
        self.iter_per_epoch = max(int(n_imgs / self.net.optimizer_batch + 0.5),
                                  1)
        self.net.max_iter = self.iter_per_epoch * max(self.net.max_epoch, 1)

        rows = None
        if self.world > 1:
            from darknet_tpu_torch.parallel.multihost import \
                process_batch_slice

            rows = process_batch_slice(self.net.optimizer_batch)
        self.loader = DetectionLoader(
            train_paths, w=self.net.w, h=self.net.h, rows=rows,
            batch=self.net.optimizer_batch, boxes=self.max_boxes,
            classes=classes, jitter=self.jitter, hue=self.net.hue,
            saturation=self.net.saturation, exposure=self.net.exposure,
            flip=self.net.flip, blur=self.net.blur,
            gaussian_noise=self.net.gaussian_noise, mixup=self.net.mixup,
            threads=loader_threads, processes=self._auto_procs(
                loader_processes, loader_threads), seed=seed,
            bad_dir=save_dir, show_imgs=show_imgs, show_imgs_dir=save_dir,
            out_dtype=self._loader_out_dtype())
        self._upload_x = PinnedUploader(self.device)
        self._upload_y = PinnedUploader(self.device)

        self._step_cache: dict = {}
        self._graph_cache: dict = {}

        from darknet_tpu_torch.utils.metrics import MetricsLogger

        self.metrics = MetricsLogger(metrics_path, log=log)

        if resume:
            path = resume if isinstance(resume, str) else self.state_path
            if os.path.isfile(path) or ck.resolve_sharded_dir(path):
                self.load_state(path)
            elif isinstance(resume, str):
                raise FileNotFoundError(f"resume checkpoint not found: {path}")

    @staticmethod
    def _auto_procs(loader_processes: int, loader_threads: int) -> int:
        """-1 = auto: spawn-based process workers on multi-core hosts, a
        thread pool on a single core."""
        if loader_processes != -1:
            return max(loader_processes, 0)
        ncpu = os.cpu_count() or 1
        return 0 if ncpu <= 2 else min(loader_threads, ncpu - 1)

    def _loader_out_dtype(self):
        """bf16 batches when the step computes in bf16 and the graph opens
        with a conv (`darknet_tpu/train/trainer.py:202-216`): the conv
        casts its input to the compute dtype before anything reads it
        (`ops/conv._conv_block_train`), so the host's cast gives the same
        bits.  A graph that opens with [crop] (YOLOv1) computes on the
        input first and keeps f32."""
        if self.compute_dtype == torch.bfloat16 and \
                self.graph.layers[0].kind == "convolutional":
            return torch.bfloat16
        return None

    @property
    def curr_iter(self) -> int:
        return self.seen // max(self.net.optimizer_batch, 1)

    def _step_generator(self) -> torch.Generator:
        """The generator of one step's random layers: on the training
        device (the masks are drawn where the activations are, never on
        the host), seeded from the trainer's CPU generator, so a resumed
        run draws the masks the uninterrupted run would."""
        seed = int(torch.randint(2 ** 62, (), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(
            seed + self.rank)

    # ------------------------------------------------------------------
    def _step_for(self, w: int, h: int):
        """The step of one resolution bucket (graph rebuilt, cached)."""
        key = (w, h)
        if key not in self._step_cache:
            if (w, h) == (self.net.w, self.net.h):
                g = self.graph
            else:
                g = self._graph_cache.get(key)
                if g is None:
                    from darknet_tpu_torch.config.cfg import patch_cfg_dims

                    g = build_graph(patch_cfg_dims(self.cfg, w, h),
                                    train=True)
                    g.net.max_iter = self.net.max_iter
                    self._graph_cache[key] = g
            kw = dict(compute_dtype=self.compute_dtype,
                      accum=max(g.net.subdiv, 1), remat=self.remat,
                      train_act_dtype=torch.bfloat16 if self.act16 else None)
            if self.mesh is not None:
                from darknet_tpu_torch.parallel import make_dp_train_step

                self._step_cache[key] = make_dp_train_step(g, self.mesh,
                                                           **kw)
            else:
                self._step_cache[key] = make_train_step(g, **kw)
        return self._step_cache[key]

    def _pick_dims(self, avg_loss) -> tuple:
        net = self.net
        it = self.curr_iter
        if not self.random_coef:
            return net.w, net.h
        coef = 1.4 if abs(self.random_coef - 1.0) <= 1e-6 else \
            self.random_coef
        rng = np.random.default_rng(it)
        scale = rng.uniform(1.0, coef)
        if rng.integers(0, 2):
            scale = 1.0 / scale
        step = net.resize_step
        dim_w = int(round(scale * net.w / step + 1)) * step
        dim_h = int(round(scale * net.h / step + 1)) * step
        max_w = int(round(coef * net.w / step + 1)) * step
        max_h = int(round(coef * net.h / step + 1)) * step
        if avg_loss < 0 or it > net.max_iter - 100:
            dim_w, dim_h = max_w, max_h
        return max(dim_w, step), max(dim_h, step)

    # ------------------------------------------------------------------
    def train(self, max_iters: int | None = None, map_hook=None) -> float:
        """Run the training loop.  Returns the final avg loss.  map_hook(it,
        mAP) is called after each in-training mAP."""
        net = self.net
        avg_loss = self._avg_loss
        avg_time = -1.0
        best_map = self._best_map
        iter_save = self.curr_iter
        iter_map = max(net.burn_in, self.curr_iter)
        map_step = max(100, self.iter_per_epoch)
        end_iter = net.max_iter if max_iters is None else \
            min(net.max_iter, self.curr_iter + max_iters)
        dim_w, dim_h = self._dims if self._dims else (net.w, net.h)

        from collections import deque

        pending = deque()
        t_prev = None

        def _drain_one():
            nonlocal avg_loss, avg_time
            p_it, p_lr, p_w, p_h, p_dt, m = pending.popleft()
            loss = float(m["loss"])
            avg_loss = loss if avg_loss < 0 else avg_loss * 0.9 + loss * 0.1
            self._avg_loss = avg_loss
            remaining = (net.max_iter - p_it) * p_dt / 3600.0
            avg_time = remaining if avg_time < 0 else \
                0.01 * remaining + 0.99 * avg_time
            self.log(f"[{p_it:04d}] loss: {loss:.2f}, avg loss: "
                     f"{avg_loss:.2f}, lr: {p_lr:.2e}, images: "
                     f"{p_it * net.optimizer_batch}, {avg_time:.2f} hours "
                     f"left ({p_dt:.2f}s/iter)")
            self.metrics.step(
                p_it, loss=loss, avg_loss=avg_loss, lr=p_lr,
                imgs_per_sec=net.optimizer_batch / max(p_dt, 1e-9),
                count=int(m["count"]),
                class_loss=float(m["class_loss"]),
                dims=[p_w, p_h])
            self._chart["iters"].append(p_it)
            self._chart["losses"].append(avg_loss)
            if p_it % 10 == 0 or p_it >= end_iter:
                self._render_chart()

        def _drain_all():
            while pending:
                _drain_one()

        # SIGTERM/SIGINT: finish the iteration, save the resumable state,
        # return (installable from the main thread only)
        import signal

        stop_requested = []
        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(
                    sig, lambda *_: stop_requested.append(True))
        except ValueError:
            prev_handlers = {}

        def _stop_agreed() -> bool:
            # a signal may reach one rank only, or the ranks at different
            # iterations: stopping alone would strand the others in the
            # step's collectives.  Every iteration the ranks agree: any
            # rank signalled stops every rank at this same boundary.
            if self.world <= 1:
                return bool(stop_requested)
            import torch.distributed as dist

            # NCCL sums on the card, gloo on the host
            flag = torch.tensor([float(bool(stop_requested))],
                                device=self.device if dist.get_backend(
                                    self.mesh.group) == "nccl" else "cpu")
            dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                            group=self.mesh.group)
            if flag.item() and not stop_requested:
                stop_requested.append(True)   # so that the save runs
            return bool(stop_requested)

        try:
            while not _stop_agreed() and self.curr_iter < end_iter:
                # multi-scale cadence keyed to the global iteration
                if self.random_coef and self.curr_iter % 10 == 0:
                    dim_w, dim_h = self._pick_dims(avg_loss)
                    self._dims = (dim_w, dim_h)
                    self.loader.resize(dim_w, dim_h)
                    self.log(f"Resizing: {dim_w} x {dim_h}")
                t0 = time.perf_counter()
                x, y = self.loader.next()
                # a batch started before a resize keeps its own bucket
                dim_h_b, dim_w_b = x.shape[1], x.shape[2]
                step = self._step_for(dim_w_b, dim_h_b)
                # the reference bumps curr_iter before the update, so the
                # first update's lr is that of iteration 1
                lr = get_lr(net, self.curr_iter + 1,
                            rand01=float(np.random.default_rng(
                                self.curr_iter + 1).uniform()))
                xt, yt = self._upload_x(x), self._upload_y(y)
                self.params, self.opt_state, _cost, metrics = step(
                    self.params, self.opt_state, xt, yt, lr,
                    self._step_generator())

                self.seen += net.optimizer_batch
                it = self.curr_iter
                now = time.perf_counter()
                dt = now - (t_prev if t_prev is not None else t0)
                t_prev = now
                pending.append((it, lr, dim_w_b, dim_h_b, dt, metrics))
                while len(pending) > self.metric_lag:
                    _drain_one()

                if self.calc_map and self.val_paths and \
                        (it >= iter_map or it == net.max_iter):
                    _drain_all()
                    m = self.evaluate_map()
                    self.log(f"mAP@0.5 = {m * 100:.2f}%")
                    self.metrics.map_event(it, m)
                    self._chart["map_iters"].append(it)
                    self._chart["maps"].append(m)
                    self._render_chart()
                    if m > best_map:
                        best_map = m
                        self._best_map = m
                        self.save(suffix="best")
                    iter_map = it + map_step
                    if map_hook:
                        map_hook(it, m)

                if it >= iter_save + 1000 or it % 1000 == 0:
                    iter_save = it
                    _drain_all()
                    self.save(suffix=str(it))
                    self.save_state()
            _drain_all()
        finally:
            for sig, h in prev_handlers.items():
                signal.signal(sig, h)
        if stop_requested:
            self.log(f"Preempted at iteration {self.curr_iter}: "
                     f"saving resumable state")
            self.save(suffix="preempt")
            self.save_state()
            return avg_loss
        self.save(suffix="final")
        self.save_state()
        return avg_loss

    # ------------------------------------------------------------------
    def evaluate_map(self, iou_thresh: float = 0.5) -> float:
        """In-training mAP on a weight-copied inference net (net_map /
        CopyNetWeights, detector.cpp:218-253).  The inference Network is
        built once from the inference graph and cached; every call folds
        the current weights again and copies them to the device.  It
        computes in f32, the JAX package's default (on the card the f32
        region kernel), at batch 4 with the reference's own bilinear
        resize."""
        from darknet_tpu_torch.eval.map import validate_detector
        from darknet_tpu_torch.nn.network import Network

        net = self._map_net
        graph = build_graph(self.cfg, train=False) if net is None else \
            net.graph
        params = paramlib.params_to_torch(graph, paramlib.fuse_conv_batchnorm(
            graph, paramlib.train_params_to_numpy(self.graph, self.params)),
            self.device)
        if net is None:
            net = self._map_net = Network(graph, params, device=self.device)
        else:
            net.params = params
        batch = 4 if len(self.val_paths) >= 4 else 1
        mesh = None
        if self.world > 1 and len(self.val_paths) >= self.world:
            # ride the training mesh: each rank predicts its block of a
            # batch, every rank matches the gathered detections
            from darknet_tpu_torch.parallel.mesh import round_batch_to_mesh

            mesh = self.mesh
            batch = round_batch_to_mesh(batch, self.world)
        res = validate_detector(net, self.val_paths, self.classes,
                                iou_thresh=iou_thresh, progress=False,
                                batch=batch, resize="darknet", mesh=mesh)
        return res.map

    def _numpy_state(self):
        to_np = lambda tree: paramlib.train_params_to_numpy(self.graph, tree)
        opt = {k: (v if k == "t" else to_np(v))
               for k, v in self.opt_state.items()}
        return to_np(self.params), opt

    def _render_chart(self) -> None:
        """chart.png in save_dir, and a live window where one can open
        (the reference draws per iteration with max_loss=5,
        detector.cpp:122-123,269-270; rendered every 10th iteration, at
        each mAP and at the end, as in the JAX package, which draws only
        where cv2 imports: the port's primitives always can)."""
        from darknet_tpu_torch.apps import visualize as viz

        if self.rank:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        img = viz.draw_loss_chart(
            self._chart["iters"], self._chart["losses"],
            self._chart["map_iters"], self._chart["maps"],
            max_iter=self.net.max_iter,
            path=os.path.join(self.save_dir, "chart.png"))
        viz.safe_imshow("average loss", img[..., ::-1])

    def save_state(self, path: str | None = None) -> str:
        """Write the full resumable state: one `.ckpt.npz`, or in a world
        of several ranks the sharded directory, which every rank calls
        for (each writes its part)."""
        os.makedirs(self.save_dir, exist_ok=True)
        path = path or self.state_path
        extra = {"avg_loss": self._avg_loss, "best_map": self._best_map}
        if self._dims:
            extra["dim_w"], extra["dim_h"] = self._dims
        if self._chart["iters"]:
            extra["chart_iters"] = np.asarray(self._chart["iters"], np.int64)
            extra["chart_losses"] = np.asarray(self._chart["losses"],
                                               np.float32)
        if self._chart["map_iters"]:
            extra["chart_map_iters"] = np.asarray(self._chart["map_iters"],
                                                  np.int64)
            extra["chart_maps"] = np.asarray(self._chart["maps"], np.float32)
        params, opt = self._numpy_state()
        save = ck.save_checkpoint
        if self.world > 1:
            save = functools.partial(ck.save_checkpoint_sharded,
                                     group=self.mesh.group)
        save(path, params, opt, seen=self.seen,
             rng_key=self._gen.get_state().numpy(), extra=extra)
        self.log(f"Saving full train state to {path}")
        return path

    def load_state(self, path: str | None = None) -> None:
        """Restore params, optimizer slots, seen and the Generator from a
        state written by save_state (exact resume)."""
        path = path or self.state_path
        params_t, opt_t = self._numpy_state()
        load = ck.load_checkpoint
        if os.path.isdir(path) or ck.resolve_sharded_dir(path):
            # a base name whose state sits at a .tmp/.old swap sibling
            # resolves (and is promoted) inside the loader
            load = functools.partial(
                ck.load_checkpoint_sharded,
                group=self.mesh.group if self.mesh is not None else None)
        params, opt, seen, rng, extra = load(path, params_t, opt_t)
        self.params = paramlib.train_params_to_torch(self.graph, params,
                                                     self.device)
        self.opt_state = {
            k: (int(v) if k == "t" else paramlib.numpy_to_train_layout(
                self.graph, v, self.device)) for k, v in opt.items()}
        self.seen = seen
        if rng is not None:
            self._gen.set_state(torch.from_numpy(np.asarray(rng, np.uint8)))
        self._avg_loss = float(extra.get("avg_loss", -1.0))
        self._best_map = float(extra.get("best_map", 0.0))
        if "chart_iters" in extra:
            self._chart = {
                "iters": [int(v) for v in extra["chart_iters"]],
                "losses": [float(v) for v in extra["chart_losses"]],
                "map_iters": [int(v) for v in
                              extra.get("chart_map_iters", [])],
                "maps": [float(v) for v in extra.get("chart_maps", [])],
            }
        if "dim_w" in extra:
            self._dims = (int(extra["dim_w"]), int(extra["dim_h"]))
            self.loader.resize(*self._dims)
        # continue the loader's seed stream where the saved run left it
        self.loader.fast_forward(self.curr_iter)
        self.log(f"Resumed full train state from {path} "
                 f"(iteration {self.curr_iter})")

    def close(self) -> None:
        """Stop the loader pool (idempotent)."""
        if getattr(self, "loader", None) is not None:
            self.loader.close()

    def save(self, suffix: str = "") -> str:
        name = f"{self.save_name}_{suffix}.weights" if suffix \
            else f"{self.save_name}.weights"
        path = os.path.join(self.save_dir, name)
        if self.rank:
            # one writer: every rank holds the same params
            return path
        os.makedirs(self.save_dir, exist_ok=True)
        wio.save_weights(self.graph, paramlib.train_params_to_numpy(
            self.graph, self.params), path, seen=self.seen)
        self.log(f"Saving weights to {path}")
        return path


def train_detector(data_file: str, model_file: str,
                   weights_file: str | None = None, *, clear: bool = False,
                   max_iters: int | None = None, calc_map: bool = False,
                   loader_processes: int = 0, **kw) -> float:
    """TrainDetector with the reference's entry signature (detector.cpp:
    27-324): resolve the .data file, build the trainer, run the loop,
    return the final EMA avg loss (-1.0 when no iteration ran).  `device`
    and the trainer's other options pass through `kw`."""
    from darknet_tpu_torch.config.metadata import Metadata

    md = Metadata.from_file(data_file)
    train_paths = md.load_paths("train")
    val_paths = (md.load_paths("valid")
                 if (calc_map and md.valid_list) else [])
    weights = (weights_file
               if weights_file and os.path.exists(weights_file) else None)
    trainer = DetectorTrainer(
        model_file, train_paths, weights=weights, classes=md.classes,
        clear=clear, calc_map=calc_map and bool(val_paths),
        val_paths=val_paths, save_dir=md.backup_dir,
        save_name=os.path.splitext(os.path.basename(model_file))[0]
        or "model", loader_processes=loader_processes, **kw)
    try:
        return float(trainer.train(max_iters=max_iters))
    finally:
        trainer.close()
