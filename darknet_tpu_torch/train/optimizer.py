"""Darknet's optimizers (`darknet_tpu/train/optimizer.py:53-232`), updating
the port's torch params in place.

Gradients are ascent directions (darknet deltas are target minus
prediction), so the rules are darknet's, which `torch.optim` does not
express.  SGD + momentum (UpdateConvolutionalLayerGpu):

    u += g;  u += -decay * batch * w     (decay on "w" only)
    w += (lr / batch) * u;  u *= momentum

Adam (adam_update_gpu): d = u + g - decay * batch * p on every array,
m, v moments with bias correction, p += lr * m_hat / (sqrt(v_hat) + eps),
the rate not divided by batch.

Update gates (UpdateNetworkGpu): train_only_bn never applies; a layer with
burnin_update or dont_update applies once its iteration threshold has
passed, and while it is closed the gradients accumulate in `u`, so the
backlog applies when it opens.  "w" is scrubbed of NaN/inf (weights and
their updates) before the apply, and a conv with clip= is clamped after.
The iteration counter state["t"] (a Python int) counts optimizer calls
from iter0 and is incremented before the gates compare, as the
reference's curr_iter is.

A param without a gradient (below a stopbackward, BN rolling statistics)
counts as a zero gradient, as the JAX package's vjp gives one: decay
still applies to it.
"""

from __future__ import annotations

import numpy as np
import torch


def _zeros_like_params(params):
    return [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]


def _has_temporary_gate(l) -> bool:
    """A gate that opens later (burnin_update / dont_update) needs a
    pending-updates buffer under Adam."""
    return bool(int(getattr(l, "burnin_update", 0) or 0)
                or int(getattr(l, "dont_update", 0) or 0))


def init_sgd_state(params, *, iter0: int = 0):
    return {"u": _zeros_like_params(params), "t": int(iter0)}


def init_adam_state(params, *, iter0: int = 0, graph=None):
    """Adam slots; the pending-updates buffer only for layers with a
    temporary gate when `graph` is given."""
    if graph is not None:
        u = [_zeros_like_params([p])[0] if _has_temporary_gate(l) else {}
             for l, p in zip(graph.layers, params)]
    else:
        u = _zeros_like_params(params)
    return {"m": _zeros_like_params(params), "v": _zeros_like_params(params),
            "u": u, "t": int(iter0)}


def _scrub_(x):
    return torch.nan_to_num_(x, nan=0.0, posinf=0.0, neginf=0.0)


def _conv_clip(l):
    """clip= constrains conv weights only (convolutional_kernels.cu:
    919-921)."""
    return l.kind == "convolutional" and getattr(l, "clip", 0.0)


NEVER = "never"


def _layer_gate(l, t: int, net):
    """None (always update), NEVER (train_only_bn) or whether iteration t
    applies the update (network_kernels.cu:226-240)."""
    if getattr(l, "train_only_bn", False):
        return NEVER
    gate = None
    bu = int(getattr(l, "burnin_update", 0) or 0)
    if bu:
        gate = bu * net.burn_in <= t
    du = int(getattr(l, "dont_update", 0) or 0)
    if du:
        gate = (du < t) if gate is None else (gate and du < t)
    return gate


def _lr_over(lr, l, batch):
    """lr * learning_rate_scale / batch in float32, as the JAX step
    computes it from its f32 lr."""
    return float(np.float32(lr) * np.float32(getattr(l, "learning_rate_scale",
                                                     1.0)) / np.float32(batch))


@torch.no_grad()
def sgd_update(graph, params, grads, state, *, lr, momentum, decay, batch):
    """One SGD + momentum step over the params list, in place; `grads` is
    a list of dicts of ascent directions (a missing entry is zero).
    Returns (params, state)."""
    t = state["t"] + 1
    for l, p, g, u in zip(graph.layers, params, grads, state["u"]):
        gate = _layer_gate(l, t, graph.net)
        if gate is NEVER:
            continue
        step = _lr_over(lr, l, batch)
        for k, pk in p.items():
            uk = u[k]
            if g.get(k) is not None:
                uk += g[k]
            if gate is False:
                continue                   # backlog accumulates
            if k == "w":
                _scrub_(uk)
                _scrub_(pk)
                uk -= decay * batch * pk
            pk += step * uk
            uk *= momentum
            if k == "w" and _conv_clip(l):
                pk.clamp_(-l.clip, l.clip)
    state["t"] = t
    return params, state


@torch.no_grad()
def adam_update(graph, params, grads, state, *, lr, B1, B2, eps, decay, batch):
    t = state["t"] + 1
    bias_corr_m = float(np.float32(1.0) - np.power(np.float32(B1),
                                                   np.float32(t)))
    bias_corr_v = float(np.float32(1.0) - np.power(np.float32(B2),
                                                   np.float32(t)))
    u_state = state.get("u") or [{} for _ in params]
    for l, p, g, m, v, u in zip(graph.layers, params, grads, state["m"],
                                state["v"], u_state):
        gate = _layer_gate(l, t, graph.net)
        if gate is NEVER:
            continue
        rate = float(np.float32(lr) * np.float32(
            getattr(l, "learning_rate_scale", 1.0)))
        for k, pk in p.items():
            gk, uk = g.get(k), u.get(k)
            acc = gk if uk is None else (uk.add_(gk) if gk is not None
                                         else uk)
            if acc is None:
                acc = torch.zeros_like(pk)
            if gate is False:
                continue                   # uk holds the backlog
            d = acc.clone()
            if k == "w":
                _scrub_(d)
                _scrub_(pk)
            d -= decay * batch * pk
            m[k].mul_(B1).add_((1 - B1) * d)
            v[k].mul_(B2).add_((1 - B2) * d * d)
            pk += rate * (m[k] / bias_corr_m) / (
                torch.sqrt(v[k] / bias_corr_v) + eps)
            if k == "w" and _conv_clip(l):
                pk.clamp_(-l.clip, l.clip)
            if uk is not None:
                uk.zero_()                 # consumed
    state["t"] = t
    return params, state
