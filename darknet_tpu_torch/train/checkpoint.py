"""Full training-state checkpoints, single process
(`darknet_tpu/train/checkpoint.py:29-89`), in the JAX package's npz
layout: `params/<layer>/<name>`, `opt/<slot>/...`, `meta/seen`,
`meta/rng` and `extra/<name>`, written atomically.

The functions take and return numpy trees (lists and dicts of arrays):
the trainer converts its torch params and optimizer slots with
`nn/params.train_params_to_numpy` (conv weights in HWIO, as the JAX
package stores them) and back.  `meta/rng` holds the state of the
trainer's torch Generator where the JAX package keeps its PRNG key.

The sharded format (`darknet_tpu/train/checkpoint.py:93-236`, for a
world of several processes) is the port's own, since the card's machine
has no orbax: a directory with one `rank-<r>.npz` a rank, holding the
entries that rank owns (entry i of the sorted names belongs to rank
i mod world, so the ranks share the writing), and `manifest.json`,
written last and atomically, which names the world and every entry's
file.  A directory counts as complete only with its manifest.  The save
writes into `<path>.tmp` and swaps it in through `<path>.old`, so a crash
leaves the previous state loadable, and a load finds a state left at
`.tmp` or `.old` by a crash in the swap and promotes it to `<path>`.  Any
world can load any world's directory: every rank reads every file.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch.distributed as dist

MANIFEST = "manifest.json"


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif tree is None:
        out[f"{prefix}/__none__"] = np.zeros(0, np.float32)
    else:
        out[prefix] = np.asarray(tree)


def _entries(params, opt_state, seen, rng_key, extra) -> dict:
    out: dict = {}
    _flatten(params, "params", out)
    _flatten(opt_state, "opt", out)
    out["meta/seen"] = np.asarray(seen, np.int64)
    if rng_key is not None:
        out["meta/rng"] = np.asarray(rng_key)
    for k, v in (extra or {}).items():
        out[f"extra/{k}"] = np.asarray(v)
    return out


def save_checkpoint(path, params, opt_state, seen: int, rng_key=None,
                    extra: dict | None = None) -> None:
    out = _entries(params, opt_state, seen, rng_key, extra)
    # atomic rolling overwrite: a kill mid-write must not destroy the
    # previous good checkpoint
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        # uncompressed, as the sharded format: zlib shrinks float weights
        # by about 7% and takes 30 times as long as the write (most of
        # a large model's save)
        np.savez(f, **out)
    os.replace(tmp, str(path))


def load_checkpoint(path, params_template, opt_template):
    """Restore (params, opt_state, seen, rng_key, extra) shaped like the
    templates (lists of dicts / optimizer-state dicts)."""
    return _restore(np.load(path, allow_pickle=False), params_template,
                    opt_template)


def _restore(data, params_template, opt_template):
    """(params, opt_state, seen, rng_key, extra) from a mapping of entry
    names to arrays (an npz file or a dict), shaped like the templates."""

    def rebuild(template, prefix):
        if isinstance(template, dict):
            return {k: rebuild(v, f"{prefix}/{k}")
                    for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return [rebuild(v, f"{prefix}/{i}")
                    for i, v in enumerate(template)]
        if template is None:
            return None
        if prefix not in data:
            # an older checkpoint lacking a newer optimizer slot keeps the
            # template's value
            return np.asarray(template)
        return data[prefix]

    params = rebuild(params_template, "params")
    opt_state = rebuild(opt_template, "opt")
    seen = int(data["meta/seen"])
    rng_key = data["meta/rng"] if "meta/rng" in data else None
    extra = {k[len("extra/"):]: data[k] for k in data
             if k.startswith("extra/")}
    return params, opt_state, seen, rng_key, extra


# ---------------------------------------------------------------------------
# Sharded: one file a rank, for a world of several processes.
# ---------------------------------------------------------------------------

def _world(group) -> tuple:
    """(rank, world size) in `group`, (0, 1) outside a distributed
    world."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _barrier(group, world) -> None:
    if world > 1:
        dist.barrier(group=group)


def save_checkpoint_sharded(path, params, opt_state, seen: int,
                            rng_key=None, extra: dict | None = None, *,
                            group=None) -> None:
    """Write the full training state as a sharded checkpoint DIRECTORY
    (the module docstring).  Every rank of `group` (the default world)
    calls it with the same state and writes only the entries it owns;
    rank 0 alone touches the directories, and the ranks meet around its
    steps.  `path` is a directory path (created; an existing one
    replaced)."""
    rank, world = _world(group)
    path = os.path.abspath(str(path))
    tmp = path + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier(group, world)
    out = _entries(params, opt_state, seen, rng_key, extra)
    names = sorted(out)
    owner = {k: i % world for i, k in enumerate(names)}
    with open(os.path.join(tmp, f"rank-{rank:05d}.npz"), "wb") as f:
        np.savez(f, **{k: out[k] for k in names if owner[k] == rank})
    _barrier(group, world)
    if rank == 0:
        manifest = {"format": "darknet_tpu_torch sharded checkpoint 1",
                    "world": world,
                    "files": {k: f"rank-{owner[k]:05d}.npz" for k in names}}
        with open(os.path.join(tmp, MANIFEST + ".tmp"), "w") as f:
            json.dump(manifest, f)
        os.replace(os.path.join(tmp, MANIFEST + ".tmp"),
                   os.path.join(tmp, MANIFEST))
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        if os.path.exists(old):
            shutil.rmtree(old)
    _barrier(group, world)


def resolve_sharded_dir(path):
    """A loadable sharded checkpoint for `path`, surviving the swap's crash
    window in save_checkpoint_sharded: a kill between `rename(path, old)`
    and `rename(tmp, path)` leaves the new complete state at `path.tmp`
    and the previous one at `path.old`.  Preference: path, path.tmp (the
    newer state: its save had finished), path.old.  A directory counts
    only with its manifest, which the save writes last and atomically.
    None when no complete checkpoint exists."""
    p = os.path.abspath(str(path))
    for cand in (p, p + ".tmp", p + ".old"):
        if os.path.isfile(os.path.join(cand, MANIFEST)):
            return cand
    return None


def load_checkpoint_sharded(path, params_template, opt_template, *,
                            group=None):
    """Restore (params, opt_state, seen, rng_key, extra) from a sharded
    checkpoint directory, as numpy trees shaped like the templates.  A
    state found at a `.tmp` / `.old` sibling (resolve_sharded_dir) is
    first promoted to `path` by rank 0 (the next save removes `path.tmp`
    before writing, which would destroy a state left there), the ranks
    meeting around it."""
    rank, world = _world(group)
    primary = os.path.abspath(str(path))
    resolved = resolve_sharded_dir(path)
    if resolved is None:
        raise FileNotFoundError(f"no complete sharded checkpoint at {path}")
    if resolved != primary:
        _barrier(group, world)
        if rank == 0:
            os.rename(resolved, primary)
        _barrier(group, world)
    with open(os.path.join(primary, MANIFEST)) as f:
        files = json.load(f)["files"]
    data: dict = {}
    for name in sorted(set(files.values())):
        with np.load(os.path.join(primary, name), allow_pickle=False) as z:
            data.update({k: z[k] for k in z.files})
    missing = set(files) - set(data)
    if missing:
        raise ValueError(f"{path}: entries missing from the rank files: "
                         f"{sorted(missing)[:5]}")
    return _restore(data, params_template, opt_template)
