"""Train-step builders (the port of the reference's ``engine/steps.py``).

Step kinds:

  weighted   — single weighted-loss pass; the dual-batch contribution-scaled
               merge realized as one weighted mean of per-example gradients
               (works with ANY optimizer).
  micro      — the small group takes ``micro_steps`` sequential local SGD
               steps over micro-batches inside one global step before the
               factor-weighted merge (LM batches).
  fused_dbl  — the paper §3.4 server update for the SGD dual-batch case,
               one step at a time: the two group gradients are taken
               separately and ``dbl_merge_flat2d`` (B2) merges and applies
               them in ONE launch over the whole flat store.  ``fused=False``
               applies the plain per-leaf ``dbl_merge_ref`` instead.

All share one signature:

    step(params, opt_state, batch, lr, rng) -> (params, opt_state, metrics)

``rng`` (a ``torch.Generator`` on the batch's device) is only consumed when
``drop_rate > 0``; ``metrics["loss"]`` is a detached device scalar.

``make_fused_phase_scan`` is the fused path's WHOLE-CHUNK form: the carry
is the flat ``(params, velocity)`` buffer pair, updated in place, and a
Python loop runs the chunk's steps — per step ONE backward of the merged
loss, its gradient raveled into one flat buffer, and ONE
``dbl_apply_flat2d`` (B1) launch.
"""
from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten

_GROUP_KEYS = ("tokens", "labels", "images", "embeddings")


def _weighted_loss(params, cfg, batch, rng, drop_rate):
    return models.loss_fn(params, cfg, batch, drop_rng=rng,
                          drop_rate=drop_rate)


def _value_and_grad(params, cfg, batch, rng, drop_rate):
    """(loss, grads tree) of the weighted loss w.r.t. every leaf."""
    leaves, treedef = tree_flatten(params)
    xs = [l.detach().requires_grad_() for l in leaves]
    loss, _ = _weighted_loss(tree_unflatten(treedef, xs), cfg, batch, rng,
                             drop_rate)
    grads = torch.autograd.grad(loss, xs)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def make_weighted_step(cfg, optimizer, *, layout=None, drop_rate: float = 0.0):
    """Weighted-loss step: batch["weight"] (or ``layout.weights()``)
    carries the dual-batch per-example contributions; any optimizer."""
    def step(params, opt_state, batch, lr, rng=None):
        if layout is not None and "weight" not in batch:
            dev = batch["labels"].device
            batch = dict(batch, weight=layout.weights().to(dev))
        loss, grads = _value_and_grad(params, cfg, batch, rng, drop_rate)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr)
        return params, opt_state, {"loss": loss}

    return step


def _small_valid_index(layout) -> torch.Tensor:
    """Row indices of the small group's VALID examples in the global padded
    batch (first ``small_valid`` rows of each small worker block), on the
    CPU."""
    pw = layout.per_worker
    nl_rows = (layout.n_workers - layout.n_small) * pw
    return torch.cat([nl_rows + w * pw + torch.arange(layout.small_valid)
                      for w in range(layout.n_small)])


def _groups(layout):
    if layout.n_small == 0 or layout.small_valid == 0:
        raise ValueError("fused dbl step needs a non-empty small group; "
                         "use make_weighted_step for the baseline")
    pw = layout.per_worker
    return (layout.n_workers - layout.n_small) * pw, \
        _small_valid_index(layout), float(layout.factor_small)


def _group_batches(batch, nl_rows, small_idx):
    """(large-group batch, small-group batch): rows [0, nl_rows) and the
    small group's valid rows."""
    keys = [k for k in batch if k in _GROUP_KEYS]
    idx = small_idx.to(batch[keys[0]].device)
    return ({k: batch[k][:nl_rows] for k in keys},
            {k: batch[k].index_select(0, idx) for k in keys})


def make_fused_dbl_step(cfg, layout, *, drop_rate: float = 0.0,
                        fused: bool = True):
    """SGD dual-batch step with the fused ``dbl_merge_flat2d`` update on
    the hot path (paper §3.4).  ``opt_state`` passes through untouched —
    the server update IS the optimizer.  ``fused=False`` selects the plain
    per-leaf reference update."""
    from repro_torch.kernels.dbl_merge import dbl_merge_tree
    from repro_torch.kernels.ref import dbl_merge_ref

    nl_rows, small_idx, f = _groups(layout)

    def step(params, opt_state, batch, lr, rng=None):
        lr_f = float(lr)
        large, small = _group_batches(batch, nl_rows, small_idx)
        loss_l, g_large = _value_and_grad(params, cfg, large, rng, drop_rate)
        loss_s, g_small = _value_and_grad(params, cfg, small, rng, drop_rate)
        with torch.no_grad():
            if fused:
                params = dbl_merge_tree(params, g_large, g_small, factor=f,
                                        lr=lr_f)
            else:
                params = tree_map(
                    lambda p, gl, gs: dbl_merge_ref(p, gl, gs, factor=f,
                                                    lr=lr_f),
                    params, g_large, g_small)
            loss = (loss_l + f * loss_s) / (1.0 + f)
        return params, opt_state, {"loss": loss, "loss_large": loss_l,
                                   "loss_small": loss_s}

    return step


def make_fused_phase_scan(cfg, layout, spec, *, lr: float,
                          drop_rate: float = 0.0, momentum: float = 0.0):
    """The fused dual-batch hot path for a chunk of a phase.

    Returns ``phase_fn(p2, v2, batches, rngs) -> (p2, v2, losses)``:

      * ``p2`` / ``v2`` — flat ``(rows, LANE)`` f32 param / velocity
        buffers from ``spec.ravel`` (``v2 = None`` when ``momentum == 0``),
        updated IN PLACE and returned;
      * ``batches`` — the chunk's batches stacked on a leading steps axis;
      * ``rngs`` — per-step dropout generators (None when
        ``drop_rate == 0``);
      * ``losses`` — the per-step merged loss, stacked, on the device (the
        caller reads it back once per chunk).

    Per step this does ONE backward pass and ONE kernel launch.  The loss
    differentiated is the already-merged scalar ``(L_L + f·L_S)/(1+f)``:
    gradients are linear, so its gradient IS the paper's merged gradient
    ``(g_L + f·g_S)/(1+f)``.  It is taken w.r.t. the leaves
    ``spec.unravel`` gives (views of the buffer, or casts to the leaf
    dtypes) and raveled into one flat buffer — the values the gradient
    w.r.t. the flat buffer has, without autograd's per-leaf f32 copies
    and their concatenation beside it — and ``dbl_apply_flat2d`` finishes
    with the single apply(+momentum) sweep.

    Mixed precision: when ``spec`` has a bf16 ``store_dtype`` the ``p2``
    carry is the ``(shadow, master)`` pair — the forward/backward runs on
    the exact f32 copy of the bf16 shadow (so only the stored weights are
    rounded and the gradient reaches the kernel unrounded), and the
    kernel's master form writes the f32 master and the re-rounded shadow
    in the same launch.
    """
    from repro_torch.kernels.dbl_merge import dbl_apply_flat2d

    nl_rows, small_idx, f = _groups(layout)
    lr_f = float(lr)
    mom = float(momentum)
    mixed = spec.store_dtype != torch.float32

    def merged_grad(src, batch, rng):
        """(merged loss, its gradients) at the leaves ``spec.unravel(src)``
        gives; the graph, which holds those leaves, is gone on return."""
        leaves, treedef = tree_flatten(spec.unravel(src))
        xs = [l.detach().requires_grad_() for l in leaves]
        params = tree_unflatten(treedef, xs)
        large, small = _group_batches(batch, nl_rows, small_idx)
        loss_l, _ = _weighted_loss(params, cfg, large, rng, drop_rate)
        loss_s, _ = _weighted_loss(params, cfg, small, rng, drop_rate)
        loss = (loss_l + f * loss_s) / (1.0 + f)
        return loss.detach(), torch.autograd.grad(loss, xs)

    def phase_fn(p2, v2, batches, rngs):
        c = next(iter(batches.values())).shape[0]
        losses = []
        for j in range(c):
            batch = {k: b[j] for k, b in batches.items()}
            rng = rngs[j] if rngs is not None else None
            shadow = p2[0] if mixed else p2
            # the flat gradient's buffer first, while the block the last
            # step's gradient freed is whole: taken after the backward, it
            # would find that block split by the step's smaller tensors
            g2 = torch.empty(spec.shape, dtype=torch.float32,
                             device=shadow.device)
            loss, grads = merged_grad(shadow.float() if mixed else shadow,
                                      batch, rng)
            spec.ravel_master(tree_unflatten(spec.treedef, list(grads)),
                              out=g2)
            del grads
            kw = {"vel2": v2, "momentum": mom} if mom > 0 else {}
            if mixed:
                dbl_apply_flat2d(shadow, g2, lr=lr_f, master2=p2[1], **kw)
            else:
                dbl_apply_flat2d(p2, g2, lr=lr_f, **kw)
            # free this step's gradient before the next step allocates
            # its own (the allocator hands its memory only to work queued
            # after the launch on this stream)
            del g2
            losses.append(loss)
        return p2, v2, torch.stack(losses)

    return phase_fn


def make_micro_step(cfg, optimizer, *, layout, micro_steps: int = 2,
                    drop_rate: float = 0.0):
    """Micro-update mode (the reference's beyond-weighted variant): the
    small group's rows split into ``micro_steps`` sequential micro-batches;
    local SGD steps run over them from the pulled params, and the delta
    merges into the global update with the model-update factor —
    recovering ASP's higher small-batch update frequency synchronously.
    The large group's gradient goes through ``optimizer``."""
    n_small_rows = layout.n_small * layout.per_worker
    nl_rows = layout.global_batch - n_small_rows
    msz = n_small_rows // micro_steps
    f = layout.factor_small

    def step(params, opt_state, batch, lr, rng=None):
        tokens, labels = batch["tokens"], batch["labels"]
        big = {"tokens": tokens[:nl_rows], "labels": labels[:nl_rows]}
        loss_b, g_big = _value_and_grad(params, cfg, big, rng, drop_rate)

        # small-group local SGD over micro-batches
        p_small, losses = params, []
        for j in range(micro_steps):
            rows = slice(nl_rows + j * msz, nl_rows + (j + 1) * msz)
            micro = {"tokens": tokens[rows], "labels": labels[rows]}
            ls, g = _value_and_grad(p_small, cfg, micro, rng, drop_rate)
            with torch.no_grad():
                p_small = tree_map(lambda w, gg: w - (lr * gg).to(w.dtype),
                                   p_small, g)
            losses.append(ls)

        # merge: factor-scaled small-group delta + large-group step
        with torch.no_grad():
            delta = tree_map(lambda a, b: a - b, p_small, params)
            params2, opt_state = optimizer.update(g_big, opt_state, params,
                                                  lr)
            params2 = tree_map(
                lambda p, d: p + (f * d.float()).to(p.dtype), params2, delta)
        return params2, opt_state, {"loss": loss_b,
                                    "loss_small": torch.stack(losses).mean()}

    return step
