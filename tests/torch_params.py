"""Helpers of the port's tests: numpy yolov4 params whose heads are not
saturated, and the slot matcher that compares two served triples, and chip_smoke.py's
test graphs.

At random init a deep yolov4 damps its heads to sigmoid(~1e-6), where
every score ties and a served kept set is decided by sum-order noise.
`lively_params` raises the BN scales to 1.5 and scales the three head
convs so that the head logits spread over O(1).  Imports no jax.
"""

import importlib.util
import pathlib

import numpy as np

from darknet_tpu_torch.nn import params as tparams

HEAD_GAIN = {138: 30.0, 149: 280.0, 160: 1300.0}     # yolov4's head convs


def lively_params(graph, seed=0, bn_scale=1.5, head_gain=None):
    """Unfused numpy params whose heads are not saturated at 0.5: BN
    scales times `bn_scale`, head conv i's weights times head_gain[i]
    (default: yolov4's HEAD_GAIN)."""
    head_gain = HEAD_GAIN if head_gain is None else head_gain
    p = tparams.init_params(graph, seed=seed)
    for i, d in enumerate(p):
        if "scales" in d:
            d["scales"] = d["scales"] * np.float32(bn_scale)
        if i in head_gain:
            d["w"] = d["w"] * np.float32(head_gain[i])
    return p


def match_slots(tb, ref_tb):
    """Per image, the reference slot that holds each slot's candidate: the
    one with the nearest box.  The top-k ranks exact objectness ties by
    index, but sum-order noise in one of the two runs can split such a
    tie the other way (yolov4 at 64 px, seed 0, has one), and then the
    two candidates trade slots.  Asserts the match is one-to-one."""
    tb, ref_tb = np.asarray(tb), np.asarray(ref_tb)
    d = np.abs(tb[:, :, None, :] - ref_tb[:, None, :, :]).max(-1)
    slot = d.argmin(-1)
    assert all(len(set(s)) == len(s) for s in slot), "slots match twice"
    return slot


def matched(ref_triple, slot):
    """The reference triple (boxes, objectness, probs) in matched order."""
    tb, ov, probs = (np.asarray(t) for t in ref_triple)
    return (np.take_along_axis(tb, slot[..., None], axis=1),
            np.take_along_axis(ov, slot, axis=1),
            np.take_along_axis(probs, slot[..., None], axis=1))


def chip_smoke():
    """chip_smoke.py as a module, read by file (an installed package named
    `tests` may shadow this directory): its test cfgs NARROW_CSP_CFG,
    conv_stack_cfg and WIDE_LAYERS."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
