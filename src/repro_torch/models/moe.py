"""GShard/Mixtral-style MoE FFN with capacity-based einsum dispatch (the
port of the reference's ``models/moe.py``).

Tokens reach the experts through one-hot dispatch / combine tensors, so
the layer is dense einsums (cuBLAS on the card), as in the reference: no
ragged gather or scatter.  Top-k routing with a capacity factor, the
Switch-style auxiliary load-balance loss, router-masked padding experts
(``pad_to``) and an optional dense residual MLP in parallel (arctic).

Choices are ranked by a stable descending sort, so equal gates go to the
lower expert index first, as ``jax.lax.top_k`` ranks them (``torch.topk``
orders ties otherwise, on either device); the order decides which choice
wins a capacity slot.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import swiglu
from repro_torch.models.shard_ctx import constrain_first, on_whole, whole


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def router_probs(x, w_router, real_experts: int | None = None):
    """Softmax routing probabilities over the router's columns, in f32;
    columns from ``real_experts`` on (padding experts) get exactly 0."""
    logits = x.float() @ w_router.float()                        # (..., E)
    if real_experts is not None and real_experts < logits.shape[-1]:
        idx = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(idx < real_experts, logits,
                             torch.full_like(logits, -1e30))
    return torch.softmax(logits, dim=-1)


def top_k_choices(probs, top_k: int):
    """(gate values, expert indices), each (..., G, top_k): every token's
    top_k experts, highest gate first, equal gates lower index first."""
    # on a mesh the experts dim is made whole first: each token's ranking
    # needs all its gates (a no-op on plain tensors)
    vals, idx = torch.sort(whole(probs, -1), dim=-1, descending=True,
                           stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def dispatch_tensors(gate_vals, gate_idx, n_experts: int, capacity: int):
    """Dispatch (..., G, E, C) 0/1 floats and combine (..., G, E, C) gate
    weights of the chosen experts.  The choices queue for capacity in
    k-major order — every token's first choice, then every token's
    second, and so on — and a choice whose place in its expert's queue is
    ``>= capacity`` is dropped."""
    *lead, g, top_k = gate_idx.shape
    e = n_experts
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    onehot = _one_hot(gate_idx, e)                                # (..., G, k, E)
    flat = onehot.transpose(-3, -2).reshape(*lead, top_k * g, e)  # (..., kG, E)
    pos_in_expert = torch.cumsum(flat, dim=-2) - flat
    pos = torch.sum(pos_in_expert * flat, dim=-1)                 # (..., kG)
    within = (pos < capacity) & (torch.sum(flat, dim=-1) > 0)
    pos = torch.where(within, pos, torch.zeros_like(pos)).to(torch.int64)

    cap_onehot = _one_hot(pos, capacity) * within[..., None]      # (..., kG, C)
    disp = torch.einsum("...ge,...gc->...gec", flat, cap_onehot)
    disp = disp.reshape(*lead, top_k, g, e, capacity).sum(dim=-4)
    gates_flat = gate_vals.transpose(-2, -1).reshape(*lead, top_k * g)
    comb = torch.einsum("...ge,...gc,...g->...gec", flat, cap_onehot,
                        gates_flat)
    comb = comb.reshape(*lead, top_k, g, e, capacity).sum(dim=-4)
    return disp, comb


def top_k_dispatch(probs, top_k: int, capacity: int):
    """Dispatch and combine tensors of a group of G tokens.

    probs: (..., G, E) token-major routing probabilities (leading dims
    are independent groups).  Returns dispatch (..., G, E, C) and combine
    (..., G, E, C): ``dispatch_tensors`` of the ``top_k_choices``."""
    return dispatch_tensors(*top_k_choices(probs, top_k), probs.shape[-1],
                            capacity)


def load_balance_loss(probs, top1_idx, num_experts: int):
    """Switch-style aux loss: ``E * sum_e f_e * p_e``."""
    me = probs.reshape(-1, probs.shape[-1]).mean(dim=0)          # (E,)
    ce = _one_hot(top1_idx.reshape(-1), num_experts).mean(dim=0)
    return num_experts * torch.sum(me * ce)


def _experts(xe, wg, wi, wo):
    h = torch.nn.functional.silu(torch.einsum("necd,edf->necf", xe, wg)) \
        * torch.einsum("necd,edf->necf", xe, wi)
    return torch.einsum("necf,efd->necd", h, wo)


def expert_ffn(xe, wg, wi, wo):
    """Each expert's SwiGLU on its capacity slots: xe (N, E', C, D), wg /
    wi (E', D, F), wo (E', F, D) -> (N, E', C, D).  On a mesh it runs on
    each rank's shards (``local_map``): the groups N over the data axes
    where they divide, and on the model axis the experts where they
    divide it, else the ff dim (the output then a pending sum), else
    whole; the weights gathered over the data axes (their gradients a
    pending sum there).  DTensor's own einsum makes views of strided
    local shards that fail (arctic's 128 experts) and flattens uneven
    expert shards in the backward (granite's 40)."""
    from repro_torch.core.dtensor import axis_sizes, is_dtensor
    if not is_dtensor(xe):
        return _experts(xe, wg, wi, wo)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xe.device_mesh
    sizes = axis_sizes(mesh)
    data = [a for a in mesh.mesh_dim_names if a in ("pod", "data")]
    dsize = 1
    for a in data:
        dsize *= sizes[a]
    by_rows = xe.shape[0] % dsize == 0
    m = sizes.get("model", 1)
    mode = ("experts" if wg.shape[0] % m == 0 else
            "ff" if wg.shape[2] % m == 0 else "whole") if m > 1 else "whole"
    R, P = Replicate(), Partial()
    x_in, x_grad, out, w_in, w_grad = [], [], [], [[], [], []], [[], [], []]
    model_w = {"experts": (Shard(0), Shard(0), Shard(0)),
               "ff": (Shard(2), Shard(2), Shard(1)),
               "whole": (R, R, R)}[mode]
    for a in mesh.mesh_dim_names:
        if a in data:
            xp = Shard(0) if by_rows and sizes[a] > 1 else R
            x_in.append(xp)
            x_grad.append(xp)
            out.append(xp)
            for i in range(3):
                w_in[i].append(R)
                w_grad[i].append(P if xp != R else R)
        elif a == "model" and mode != "whole":
            x_in.append(Shard(1) if mode == "experts" else R)
            x_grad.append(Shard(1) if mode == "experts" else P)
            out.append(Shard(1) if mode == "experts" else P)
            for i in range(3):
                w_in[i].append(model_w[i])
                w_grad[i].append(model_w[i])
        else:
            for lst in (x_in, x_grad, out, *w_in, *w_grad):
                lst.append(R)
    return local_map(_experts, out_placements=out,
                     in_placements=(x_in, *w_in),
                     in_grad_placements=(x_grad, *w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        xe, wg, wi, wo)


def moe_ffn(p, x, moe_cfg, *, group_size: int | None = None,
            dropless: bool = False):
    """x: (B, S, D) -> ((B, S, D), the scalar aux loss).

    Tokens are cut into dispatch groups of ``group_size`` (GShard style;
    the largest divisor of the token count not above it), so the one-hot
    tensors stay O(tokens * E * C_group) with C_group = cf * k * group /
    E.  ``dropless`` (serving) sets the capacity to the group size, so no
    token is dropped.

    p: {"router": (D, E') f32, "wi" / "wg": (E', D, F), "wo": (E', F,
    D)}, optional {"res_wi", "res_wg", "res_wo"} (the dense residual)."""
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    tokens = b * s
    if group_size is None:
        group_size = moe_cfg.dispatch_group
    gsz = min(group_size, tokens)
    while tokens % gsz:            # a divisor of the token count
        gsz -= 1
    ng = tokens // gsz
    capacity = gsz if dropless \
        else max(k, int(moe_cfg.capacity_factor * k * gsz / e))
    xg = x.reshape(ng, gsz, d)
    probs = router_probs(xg, p["router"], real_experts=e)         # (N, G, E')
    gate_vals, gate_idx = top_k_choices(probs, k)
    # a token's first choice is its argmax (the first of equal maxima)
    aux = load_balance_loss(probs[..., :e].reshape(tokens, e),
                            gate_idx[..., 0].reshape(tokens), e)

    # the capacity queues run along every token of a group: on a mesh
    # they are built whole on every rank (DTensor's cumsum does not
    # gather a sharded scan dim, and some releases cannot flatten one)
    disp, comb = on_whole(dispatch_tensors, (gate_vals, gate_idx,
                                             probs.shape[-1], capacity), 2)
    # dispatch / combine in the compute dtype, as the reference's
    disp = disp.to(x.dtype)
    comb = comb.to(x.dtype)
    xe = torch.einsum("ngd,ngec->necd", xg, disp)                 # (N, E', C, D)
    # expert-parallel under a mesh: experts on the model axis when they
    # divide it, else the ff dim (granite's 40 experts)
    xe = constrain_first(xe, ["bh..", "b..."])
    ye = expert_ffn(xe, p["wg"], p["wi"], p["wo"])               # (N, E', C, D)
    ye = constrain_first(ye, ["bh..", "b..."])
    # on a mesh the experts dim is gathered whole (and pending sums
    # reduced) for the combine: some DTensor releases cannot flatten a
    # sharded expert dim into its contraction (a no-op on plain tensors)
    y = torch.einsum("necd,ngec->ngd", whole(ye, 1), comb)
    y = y.reshape(b, s, d).to(x.dtype)
    if "res_wi" in p:
        y = y + swiglu(x, p["res_wi"], p["res_wg"], p["res_wo"])
    return y, aux
