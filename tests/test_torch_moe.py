"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU, on the same numpy-seeded
inputs.

* ``router_probs``: within ``PROB_TOL`` (measured <= 1.8e-7); padded
  experts get exactly 0.
* ``top_k_dispatch``: dispatch and combine **bit for bit** in f32,
  capacities that drop choices included.  Its values are 0/1 products,
  integer cumsums and one division per gate, and every (token, expert,
  slot) sums at most one non-zero term.  Ties are ranked lowest expert
  index first, as ``jax.lax.top_k`` ranks them (``torch.topk`` does not):
  planted ties route as the reference's.
* ``load_balance_loss``: within ``AUX_TOL`` (measured <= 1.2e-7; the two
  means sum in other orders).
* ``moe_ffn``: outputs within ``FFN_TOL`` of the largest |output|
  (measured <= 3.2e-7 relative), aux within ``AUX_TOL``, in capacity and
  dropless modes, with group sizes that divide the token count and that
  do not, padded experts and the dense residual; the capacity cases named
  so drop choices (asserted).  At these inputs every token's k-th and
  (k+1)-th gates lie at least ``MARGIN`` apart (asserted; the smallest is
  9.8e-5), so rounding cannot flip a choice between the packages.
* The reference's ``tests/test_moe.py`` invariants, on the port.
* A planted fault — choices queued token by token (a token's k choices
  together) instead of k-major — changes the dispatch at a capacity that
  drops choices.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.models import moe

torch.set_num_threads(1)

PROB_TOL = 1e-6
AUX_TOL = 2e-6
FFN_TOL = 1e-5
MARGIN = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _probs(rng, g, e, scale=1.0):
    logits = (rng.standard_normal((g, e)) * scale).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


def _moe_params(rng, d, e, f, *, residual=False):
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5,
         "wi": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
         "wg": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
         "wo": rng.standard_normal((e, f, d)).astype(np.float32) * f ** -0.5}
    if residual:
        p["res_wi"] = rng.standard_normal((d, 2 * d)).astype(np.float32) * 0.05
        p["res_wg"] = rng.standard_normal((d, 2 * d)).astype(np.float32) * 0.05
        p["res_wo"] = rng.standard_normal((2 * d, d)).astype(np.float32) * 0.05
    return p


def _margin(probs, k):
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    s = np.sort(np.asarray(probs).reshape(-1, np.shape(probs)[-1]), -1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[1] > k else 1.0


# --------------------------------------------------------------- the router
@pytest.mark.parametrize("real", [None, 8], ids=["all", "padded"])
def test_router_probs_matches_reference(real):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    want = np.asarray(jmoe.router_probs(jnp.asarray(x), jnp.asarray(w),
                                        real_experts=real))
    got = moe.router_probs(_t(x), _t(w), real_experts=real).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= PROB_TOL
    if real:
        assert np.all(got[..., real:] == 0.0)
    # a bf16 input routes in f32
    xb = _t(x).bfloat16()
    assert moe.router_probs(xb, _t(w)).dtype == torch.float32


# ------------------------------------------------------------- the dispatch
DISPATCH_CASES = [
    # (G, E, k, capacity, logit scale): dropless-sized, granite's group at
    # its training capacity and at one that drops, a ragged group, and
    # peaked routing (scale 4) at a capacity that drops many choices
    (64, 8, 2, 64, 1.0),
    (512, 40, 8, 128, 1.0),
    (512, 40, 8, 40, 1.0),
    (33, 6, 3, 5, 1.0),
    (96, 4, 2, 20, 4.0),
]


@pytest.mark.parametrize("g,e,k,cap,scale", DISPATCH_CASES)
def test_top_k_dispatch_bit_for_bit(g, e, k, cap, scale):
    p = _probs(np.random.default_rng(g + e), g, e, scale)
    jd, jc = jmoe.top_k_dispatch(jnp.asarray(p), k, cap)
    td, tc = moe.top_k_dispatch(_t(p), k, cap)
    assert td.shape == tc.shape == (g, e, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_top_k_dispatch_over_groups_equals_one_group_at_a_time():
    """Leading group dims route each group alone (the reference vmaps)."""
    p = np.stack([_probs(np.random.default_rng(s), 32, 8) for s in range(3)])
    td, tc = moe.top_k_dispatch(_t(p), 2, 6)
    for i in range(3):
        jd, jc = jmoe.top_k_dispatch(jnp.asarray(p[i]), 2, 6)
        np.testing.assert_array_equal(td[i].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc[i].numpy(), np.asarray(jc))


@pytest.mark.parametrize("case", ["three_way", "every_third"])
def test_planted_ties_route_lowest_index_first(case):
    """Equal gates rank the lower expert first, as ``jax.lax.top_k`` does:
    [0.2, 0.4, 0.1, 0.4, 0.4, 0.3] at k = 3 picks experts 1, 3, 4 in that
    order; 64 gates with 1.0 at every third index at k = 5 pick 0, 3, 6,
    9, 12.  The order decides which choice wins a capacity slot, so
    dispatch and combine equal the reference's bit for bit."""
    if case == "three_way":
        row = np.float32([0.2, 0.4, 0.1, 0.4, 0.4, 0.3])
        k, want_idx = 3, [1, 3, 4]
    else:
        row = np.zeros(64, np.float32)
        row[::3] = 1.0
        k, want_idx = 5, [0, 3, 6, 9, 12]
    _, jidx = jax.lax.top_k(jnp.asarray(row), k)
    assert list(np.asarray(jidx)) == want_idx
    p = np.stack([row] * 6)
    for cap in (2, 6):                    # dropping and not
        jd, jc = jmoe.top_k_dispatch(jnp.asarray(p), k, cap)
        td, tc = moe.top_k_dispatch(_t(p), k, cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        chosen = np.flatnonzero(td.numpy()[0].sum(-1))
        assert list(chosen) == sorted(want_idx)


def _token_major_dispatch(probs, top_k, capacity):
    """A planted fault: the capacity queue takes each token's k choices
    together (token-major) instead of every token's first choice first."""
    g, e = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gv, gi = vals[:, :top_k], idx[:, :top_k]
    gv = gv / torch.clamp_min(gv.sum(-1, keepdim=True), 1e-9)
    flat = moe._one_hot(gi, e).reshape(g * top_k, e)
    pos = torch.sum((torch.cumsum(flat, 0) - flat) * flat, -1)
    within = pos < capacity
    cap = moe._one_hot(torch.where(within, pos, 0).long(), capacity) \
        * within[:, None]
    disp = torch.einsum("ge,gc->gec", flat, cap).reshape(g, top_k, e,
                                                          capacity).sum(1)
    return disp


def test_planted_token_major_queue_breaks_dispatch():
    p = _probs(np.random.default_rng(5), 96, 4, 4.0)
    jd, _ = jmoe.top_k_dispatch(jnp.asarray(p), 2, 20)
    bad = _token_major_dispatch(_t(p), 2, 20)
    assert not np.array_equal(bad.numpy(), np.asarray(jd))
    # at a capacity that drops nothing the queue order moves slots only
    jd, _ = jmoe.top_k_dispatch(jnp.asarray(p), 2, 96)
    bad = _token_major_dispatch(_t(p), 2, 96)
    np.testing.assert_array_equal(bad.numpy().sum(-1),
                                  np.asarray(jd).sum(-1))


# ------------------------------------------------------------------ the aux
def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    p = _probs(rng, 256, 40)
    top1 = np.argmax(p, -1).astype(np.int32)
    want = float(jmoe.load_balance_loss(jnp.asarray(p), jnp.asarray(top1),
                                        40))
    got = float(moe.load_balance_loss(_t(p), _t(top1).long(), 40))
    assert abs(got - want) <= AUX_TOL
    # an index past the experts counts for none, as jax.nn.one_hot's
    assert float(moe.load_balance_loss(_t(p[:, :4]), torch.full((256,), 7),
                                       4)) == 0.0


# ------------------------------------------------------------ the MoE layer
FFN_CASES = [
    # (id, B, S, E, k, pad_to, group, dropless, residual); the ids with
    # "drops" drop choices at their capacity
    ("capacity", 2, 24, 4, 2, 0, None, False, False),
    ("capacity-drops", 2, 24, 4, 2, 0, 8, False, False),
    ("ragged-group-drops", 3, 10, 4, 2, 0, 7, False, False),
    ("dropless", 2, 24, 4, 2, 0, None, True, False),
    ("dropless-ragged", 3, 10, 4, 2, 0, 7, True, False),
    ("padded-drops", 2, 24, 6, 2, 8, 16, False, False),
    ("residual-drops", 2, 24, 4, 2, 0, 16, False, True),
    ("granite-k8-drops", 1, 64, 40, 8, 0, None, False, False),
]


def _kept(x, p, cfg, group, dropless):
    """The (token, choice) pairs ``moe_ffn`` keeps, by its grouping."""
    tokens = x.shape[0] * x.shape[1]
    gsz = min(group or cfg.dispatch_group, tokens)
    while tokens % gsz:
        gsz -= 1
    k, e = cfg.top_k, cfg.num_experts
    cap = gsz if dropless else max(k, int(cfg.capacity_factor * k * gsz / e))
    probs = moe.router_probs(_t(x).reshape(-1, gsz, x.shape[-1]),
                             _t(p["router"]), e)
    return int(moe.top_k_dispatch(probs, k, cap)[0].sum()), tokens * k


@pytest.mark.parametrize("case", FFN_CASES, ids=[c[0] for c in FFN_CASES])
def test_moe_ffn_matches_reference(case):
    _, b, s, e, k, pad, group, dropless, res = case
    d, f = 32, 16
    rng = np.random.default_rng(7)
    cfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f, pad_to=pad,
                    dense_residual=res)
    p = _moe_params(rng, d, cfg.padded_experts, f, residual=res)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), cfg, group_size=group,
                            dropless=dropless)
    y, aux = moe.moe_ffn({n: _t(a) for n, a in p.items()}, _t(x), cfg,
                         group_size=group, dropless=dropless)
    jy = np.asarray(jy)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert np.abs(y.numpy() - jy).max() <= FFN_TOL * np.abs(jy).max()
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    probs = jmoe.router_probs(jnp.asarray(x), jnp.asarray(p["router"]), e)
    assert _margin(np.asarray(probs)[..., :e], k) > MARGIN
    kept, choices = _kept(x, p, cfg, group, dropless)
    assert (kept < choices) == ("drops" in case[0])


def test_moe_ffn_bf16_keeps_the_dtype():
    rng = np.random.default_rng(8)
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16)
    p = {n: _t(a) for n, a in _moe_params(rng, 32, 4, 16).items()}
    p = {n: a if n == "router" else a.bfloat16() for n, a in p.items()}
    x = _t(rng.standard_normal((2, 8, 32)).astype(np.float32)).bfloat16()
    y, aux = moe.moe_ffn(p, x, cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.isfinite(y.float()).all()


# --------------------------------- the reference's invariants (test_moe.py)
def test_padded_experts_never_routed():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 8, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 12).astype(np.float32))
    probs = moe.router_probs(x, w, real_experts=8)
    assert float(probs[..., 8:].max()) < 1e-12
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)


def test_dispatch_conservation():
    """Every kept (token, choice) lands in exactly one capacity slot; no
    slot holds more than one token."""
    rng = np.random.RandomState(1)
    probs = torch.softmax(torch.from_numpy(rng.randn(32, 8).astype(
        np.float32)), -1)
    disp, comb = moe.top_k_dispatch(probs, 2, capacity=6)
    assert float(disp.sum(0).max()) <= 1.0 + 1e-6
    assert float(disp.sum((1, 2)).max()) <= 2 + 1e-6
    assert float((comb * (1 - disp)).abs().max()) < 1e-6


def test_dropless_capacity_keeps_everything():
    rng = np.random.RandomState(2)
    cfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)
    d = 16
    x = torch.from_numpy(rng.randn(2, 8, d).astype(np.float32))
    p = {"router": rng.randn(d, 4), "wi": rng.randn(4, d, 8) * 0.1,
         "wg": rng.randn(4, d, 8) * 0.1, "wo": rng.randn(4, 8, d) * 0.1}
    p = {n: torch.from_numpy(a.astype(np.float32)) for n, a in p.items()}
    y, _ = moe.moe_ffn(p, x, cfg, dropless=True)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    y2, _ = moe.moe_ffn(p, x, cfg, dropless=True, group_size=4)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), atol=1e-5)


def test_expert_padding_trains_granite():
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    cfg = replace(cfg, moe=replace(cfg.moe, pad_to=6))
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    assert params["segments"][0]["moe"]["wi"].shape[1] == 6
    assert params["segments"][0]["moe"]["router"].dtype == torch.float32
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    leaves, treedef = tree_flatten(params)
    xs = [t.detach().requires_grad_() for t in leaves]
    loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, batch)
    assert bool(torch.isfinite(loss))
    grads = tree_unflatten(treedef, list(torch.autograd.grad(loss, xs)))
    gw = grads["segments"][0]["moe"]["wi"]            # (L, E_pad, D, F)
    assert float(gw[:, 5].abs().max()) < 1e-12
    assert float(grads["segments"][0]["moe"]["router"].abs().max()) > 0


def test_capacity_drops_overflow():
    """With capacity 1 and all tokens preferring one expert, later tokens
    are dropped (zero output contribution)."""
    probs = torch.tensor([[0.9, 0.1], [0.9, 0.1], [0.9, 0.1]])
    disp, _ = moe.top_k_dispatch(probs, 1, capacity=1)
    assert float(disp.sum()) == 1.0
    assert float(disp[0].sum()) == 1.0
