"""Maskable Adam + MultiStepLR with the reference's optimizer semantics.

Counterpart of `multiply_tpu/engine/optim.py`: Adam(eps=1e-8) with per-leaf
learning-rate factors and a per-leaf active mask; an inactive leaf keeps its
value, its moments and its step count, as torch leaves without gradients do
in the reference. Not `torch.optim.Adam`: the active set changes per step
(joint / pose-only / delayed-pose modes) and the train step must be able to
drop a whole update, moments included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling


class AdamState(NamedTuple):
    mu: dict  # name -> first moment
    nu: dict  # name -> second moment
    count: dict  # name -> int step count (advances only while the leaf is active)


def adam_init(params: dict) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        count={k: 0 for k in params},
    )


def adam_update(
    grads: dict,
    state: AdamState,
    params: dict,
    lr: float,
    lr_factors: dict,
    active: dict,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> AdamState:
    """One Adam step over the active leaves, updating `params` in place;
    returns the new optimizer state (the old one is left as it was)."""
    mu, nu, count = dict(state.mu), dict(state.nu), dict(state.count)
    with torch.no_grad():
        for k, p in params.items():
            if not active[k]:
                continue
            g = grads[k]
            count[k] = c = state.count[k] + 1
            mu[k] = m = b1 * state.mu[k] + (1 - b1) * g
            nu[k] = v = b2 * state.nu[k] + (1 - b2) * g * g
            m_hat = m / (1 - b1**c)
            v_hat = v / (1 - b2**c)
            p.sub_(lr * lr_factors[k] * m_hat / (torch.sqrt(v_hat) + eps))
    profiling.count("adam.leaves", sum(bool(active[k]) for k in params))
    return AdamState(mu=mu, nu=nu, count=count)


def multistep_lr(base_lr: float, epoch: int, milestones, gamma: float) -> float:
    """MultiStepLR: lr * gamma^(#milestones passed)."""
    return base_lr * gamma ** sum(1 for m in milestones if epoch >= m)
