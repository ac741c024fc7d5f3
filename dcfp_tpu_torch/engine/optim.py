"""Optimizers + LR schedules (reference optimizer.py).  Port of
``dcfp_tpu/engine/optim.py``.

SGD-momentum / AdamW with a ``no_decay`` keyword list that zeroes weight
decay on matching parameter paths (optimizer.py:34-49), and the poly decay
schedule with optional linear warmup (optimizer.py:60-79) as a pure
``step -> lr`` function.

The optimizer is functional, like the optax chain it ports: ``init(params)``
makes its state, ``update(grads, state, params)`` returns the updates and
the new state, and :func:`apply_updates` adds the updates to the params.
Each step does the optax chain's operations in its order, in float32, on
lists of tensors (``torch._foreach_*``), one rounding per operation (no
fused multiply-add), so a step gives optax's numbers.  It does not use
``torch.optim``, whose param groups carry a learning rate that the loop
would mutate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, Dict[str, torch.Tensor]]
OptState = dict


def poly_warmup_schedule(base_lr: float, num_steps: int, power: float = 0.9,
                         warmup: int = -1, warmup_ratio: float = 1e-6
                         ) -> Callable[[int], float]:
    """lr(i) = base * (1 - i/N)^power, linearly warmed up over ``warmup``
    steps when warmup > 0 (reference optimizer.py:60-68).  Computed in
    float32 in the JAX package's order, so the two give the same lr."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(1.0) - f32(min(count, num_steps)) / f32(num_steps)
        lr = f32(base_lr) * frac ** f32(power)
        if warmup > 0 and count < warmup:
            ramp = f32(1.0) - (f32(1.0) - f32(count) / f32(warmup)) * \
                f32(1.0 - warmup_ratio)
            lr = lr * ramp
        return float(lr)

    return schedule


def _decay_mask(params: Params, no_decay_keywords: Sequence[str]
                ) -> Dict[str, Dict[str, bool]]:
    """True where weight decay applies: everything except params whose
    path contains a no-decay keyword (optimizer.py:34-57).  Paths are
    'node/key', e.g. 'backbone.layer1.0.bn1/scale', as in the JAX
    package."""
    return {n: {k: not any(kw in f"{n}/{k}" for kw in no_decay_keywords)
                for k in d} for n, d in params.items()}


def tree_keys(tree) -> List[Tuple[str, str]]:
    """The (node, key) paths of a ``{node: {key: tensor}}`` tree."""
    return [(n, k) for n, d in tree.items() for k in d]


def tree_leaves(tree, keys) -> List[torch.Tensor]:
    return [tree[n][k] for n, k in keys]


def tree_of(keys, leaves) -> Params:
    out: Params = {}
    for (n, k), t in zip(keys, leaves):
        out.setdefault(n, {})[k] = t
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A functional optimizer: ``init(params) -> state`` and
    ``update(grads, state, params) -> (updates, new_state)``.

    ``state`` is ``{"count": int, "trace": tree}`` for SGD and
    ``{"count": int, "mu": tree, "nu": tree}`` for AdamW, each tree keyed
    like the params.  ``count`` starts at 0 and rises by one per update;
    the lr of an update is ``schedule(count)`` before the increment.

    ``masked``: weight decay runs under a ``no_decay`` mask, which shows
    in the state layout of the optax chain this ports, and so in the
    checkpoint files.
    """
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], Tuple[Params, OptState]]
    schedule: Callable[[int], float]
    masked: bool = False


def apply_updates(params: Params, updates: Params) -> Params:
    keys = tree_keys(params)
    return tree_of(keys, torch._foreach_add(tree_leaves(params, keys),
                                            tree_leaves(updates, keys)))


def build_optimizer(*, optim: str = "sgd", learning_rate: float = 1e-2,
                    momentum: float = 0.9, weight_decay: float = 5e-4,
                    betas: str = "0.9,0.999", num_steps: int = 40000,
                    power: float = 0.9, warmup: int = -1,
                    no_decay: Optional[str] = None,
                    params: Optional[Params] = None) -> Optimizer:
    """Build the optimizer.  ``no_decay`` is the reference's comma-joined
    keyword list (e.g. 'bn,bias'); it needs example ``params``.

    sgd: decayed weights, then the momentum trace (torch SGD: grad += wd
    * param, buf = mu * buf + grad), then ``-lr(count)``.  adamw: Adam's
    scaling (eps 1e-8 outside the square root, bias-corrected moments),
    then decoupled decay, then ``-lr(count)``.
    """
    schedule = poly_warmup_schedule(learning_rate, num_steps, power, warmup)
    keywords = [k for k in (no_decay or "").split(",") if k]
    if keywords and params is None:
        raise ValueError("no_decay masking requires example params")
    mask = _decay_mask(params, keywords) if keywords else None
    if optim not in ("sgd", "adamw"):
        raise NotImplementedError(f"optim={optim!r}")

    def add_decay(u, p, keys):
        """u + wd * p where the mask allows it."""
        idx = [i for i, (n, k) in enumerate(keys)
               if mask is None or mask[n][k]]
        if not idx:
            return u
        decayed = torch._foreach_add(
            [u[i] for i in idx],
            torch._foreach_mul([p[i] for i in idx], weight_decay))
        u = list(u)
        for i, t in zip(idx, decayed):
            u[i] = t
        return u

    def zeros(params):
        return {n: {k: torch.zeros_like(v) for k, v in d.items()}
                for n, d in params.items()}

    if optim == "sgd":
        def init(params):
            return {"count": 0, "trace": zeros(params)}

        def update(grads, state, params):
            keys = tree_keys(params)
            u = add_decay(tree_leaves(grads, keys),
                          tree_leaves(params, keys), keys)
            trace = torch._foreach_add(u, torch._foreach_mul(
                tree_leaves(state["trace"], keys), momentum))
            upd = torch._foreach_mul(trace, -schedule(state["count"]))
            return tree_of(keys, upd), {"count": state["count"] + 1,
                                        "trace": tree_of(keys, trace)}

        return Optimizer(init, update, schedule, mask is not None)

    b1, b2 = (float(x) for x in betas.split(","))
    eps = 1e-8

    def init(params):
        return {"count": 0, "mu": zeros(params), "nu": zeros(params)}

    def update(grads, state, params):
        keys = tree_keys(params)
        g = tree_leaves(grads, keys)
        mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(
            tree_leaves(state["mu"], keys), b1))
        nu = torch._foreach_mul(g, g)
        torch._foreach_mul_(nu, 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            tree_leaves(state["nu"], keys), b2))
        count = state["count"] + 1
        # the bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        u = add_decay(u, tree_leaves(params, keys), keys)
        upd = torch._foreach_mul(u, -schedule(state["count"]))
        return tree_of(keys, upd), {"count": count, "mu": tree_of(keys, mu),
                                    "nu": tree_of(keys, nu)}

    return Optimizer(init, update, schedule, mask is not None)
