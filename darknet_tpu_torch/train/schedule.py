"""Learning-rate schedules — exact port of GetCurrLr (network.cpp:32-84);
the port's copy of `darknet_tpu/train/schedule.py`.

All policies of the reference dialect: constant/step/steps/exp/poly/random/
sig/sgdr, plus the burn-in warmup ``lr * (iter/burn_in)^power`` that
overrides every policy while ``iter < burn_in``.

Note this fork's `steps` policy quirk: step boundaries are FRACTIONS of
`max_iter` (``net->max_iter * net->steps[i] > iter``, network.cpp:49) —
unlike upstream darknet where they are absolute iteration numbers.
"""

from __future__ import annotations

import math


def get_lr(net, iteration: int, rand01: float | None = None) -> float:
    """Scalar LR for a given iteration (host-side, like the reference)."""
    it = iteration
    if net.burn_in and it < net.burn_in:
        return net.lr * (it / net.burn_in) ** net.power

    p = net.policy
    if p == "constant":
        return net.lr
    if p == "step":
        return net.lr * net.scale ** (it // net.step)
    if p == "steps":
        lr = net.lr
        for s, sc in zip(net.steps, net.scales):
            if net.max_iter * s > it:
                return lr
            lr *= sc
        return lr
    if p == "exp":
        return net.lr * net.gamma ** it
    if p == "poly":
        return net.lr * (1 - it / net.max_iter) ** net.power
    if p == "random":
        r = rand01 if rand01 is not None else 0.5
        return net.lr * r ** net.power
    if p == "sigmoid":
        return net.lr * (1.0 / (1.0 + math.exp(net.gamma * (it - net.step))))
    if p == "sgdr":
        last_iter = 0
        cycle = net.sgdr_cycle if net.sgdr_cycle else max(net.max_iter, 1)
        while last_iter + cycle < it:
            last_iter += cycle
            cycle *= net.sgdr_mult
        return net.lr_min + 0.5 * (net.lr - net.lr_min) * (
            1.0 + math.cos((it - last_iter) * math.pi / cycle))
    return net.lr
