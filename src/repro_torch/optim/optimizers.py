"""Minimal functional optimizers over trees of tensors (the reference's
``optim/optimizers.py``)."""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (grads, state, params, lr) -> (new_params, new_state)


def _per_leaf(fn, params, *trees):
    """``fn`` over corresponding leaves; returns one tree per output of
    ``fn`` (each in ``params``'s structure)."""
    leaves, treedef = tree_flatten(params)
    outs = [fn(*xs, p) for *xs, p in zip(*map(tree_leaves, trees), leaves)]
    return [tree_unflatten(treedef, col) for col in zip(*outs)]


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False, state_dtype=None) -> Optimizer:
    def init(params):
        # zeros as broadcast views of one element: no memory until an
        # update writes the state (the fused dual-batch path, which
        # applies its own server update, never does)
        return {"v": tree_map(
            lambda p: torch.zeros((), dtype=state_dtype or p.dtype,
                                  device=p.device).expand(p.shape), params)}

    def update(grads, state, params, lr):
        def upd(g, v, p):
            g = g.to(v.dtype)
            if weight_decay:
                g = g + weight_decay * p.to(v.dtype)
            v_new = momentum * v + g
            step = (g + momentum * v_new) if nesterov else v_new
            return (p - lr * step.to(p.dtype)), v_new
        new_p, new_v = _per_leaf(upd, params, grads, state["v"])
        return new_p, {"v": new_v}

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        # the step count is a 0-d int32 tensor beside the params, as the
        # reference's: checkpoints hold the same leaf, and the bias
        # corrections below round as the reference's do
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        # b ** t in f32, then 1 - it in f32 (the reference's weak-typed
        # scalars), not in the host's double
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(g, m, v, p):
            g = g.to(state_dtype)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            mhat = m_new / bc1
            vhat = v_new / bc2
            # the square root in double, rounded once: the correctly
            # rounded f32 root on every device (the CPU build's vectorized
            # f32 sqrt is off by an ulp in about a sixth of the elements)
            root = torch.sqrt(vhat.double()).to(vhat.dtype)
            step = mhat / (root + eps) + weight_decay * p.to(state_dtype)
            return (p - lr * step.to(p.dtype)), m_new, v_new
        new_p, new_m, new_v = _per_leaf(upd, params, grads, state["m"],
                                        state["v"])
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        kw.pop("b1", None)
        return sgd_momentum(**kw)
    if name == "adamw":
        kw.pop("momentum", None)
        return adamw(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
