"""Full training-state checkpoints, single process
(`darknet_tpu/train/checkpoint.py:29-89`), in the JAX package's npz
layout: `params/<layer>/<name>`, `opt/<slot>/...`, `meta/seen`,
`meta/rng` and `extra/<name>`, written atomically.

The functions take and return numpy trees (lists and dicts of arrays):
the trainer converts its torch params and optimizer slots with
`nn/params.train_params_to_numpy` (conv weights in HWIO, as the JAX
package stores them) and back.  `meta/rng` holds the state of the
trainer's torch Generator where the JAX package keeps its PRNG key.
The sharded (multi-process) format is not ported.
"""

from __future__ import annotations

import os

import numpy as np


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


def save_checkpoint(path, params, opt_state, seen: int, rng_key=None,
                    extra: dict | None = None) -> None:
    out: dict = {}
    _flatten(params, "params", out)
    _flatten(opt_state, "opt", out)
    out["meta/seen"] = np.asarray(seen, np.int64)
    if rng_key is not None:
        out["meta/rng"] = np.asarray(rng_key)
    for k, v in (extra or {}).items():
        out[f"extra/{k}"] = np.asarray(v)
    # atomic rolling overwrite: a kill mid-write must not destroy the
    # previous good checkpoint
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **out)
    os.replace(tmp, str(path))


def load_checkpoint(path, params_template, opt_template):
    """Restore (params, opt_state, seen, rng_key, extra) shaped like the
    templates (lists of dicts / optimizer-state dicts)."""
    data = np.load(path, allow_pickle=False)

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
    extra = {k[len("extra/"):]: data[k] for k in data.files
             if k.startswith("extra/")}
    return params, opt_state, seen, rng_key, extra
