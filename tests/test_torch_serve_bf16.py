"""bf16 serving parity against the JAX package, on the CPU (ROADMAP C9's
serving half).

Both packages run one paged serve step, teacher-forced on the same page
pools, table rows, lengths and tokens, with bf16 params, bf16 compute and
bf16 pages, on reduced llama3-405b, deepseek-67b and arctic-480b that keep
their group widths (n_rep 16, 8 and 7) over two KV heads; the reference's
step is jitted, as its engine serves it.  The yardstick is an f32 step (the
reference's, jitted) on the same bf16-rounded weights and pools: the port's
bf16 logits must lie no further from it than ``BAND_TIMES`` the reference's
own bf16 logits do, floored at one bf16 ulp of the largest f32 logit (what
rounding the logits alone may move).  Both the decode ``(m, 1)`` and the
prefill ``(1, C)`` shapes run.

In arctic's MoE layers a bf16 run may route a token to other experts than
the f32 run does (routing is discontinuous; ROADMAP C9): the band holds
the tokens whose top-2 experts the reference's bf16 and f32 runs choose
alike in every layer (read through ``jax.debug.callback`` from its router),
and the others are counted, never more than ``MAX_FLIPPED`` of a step's
tokens.

Planted faults land outside the band: RoPE angles computed in bf16, and a
group's query heads reading the other KV head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import PageSpec as JPageSpec
from repro.serve import paged as jpg
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers
from repro_torch.serve import PageSpec
from repro_torch.serve import paged as pg

torch.set_num_threads(1)

# n_rep 16 / 8 / 7 over two KV heads, head dims 16 / 32 / 32; arctic keeps
# 4 experts, top-2 and the dense residual (``reduced``)
GEOMETRY = {"llama3-405b": dict(n_heads=32, d_model=512),
            "deepseek-67b": dict(n_heads=16, d_model=512),
            "arctic-480b": dict(n_heads=14, d_model=448)}
BAND_TIMES = 2.0
MAX_FLIPPED = 0.25
# a slot reaches 1,024 positions, where RoPE angles computed in bf16 go
# far wrong
SPEC = dict(page_len=16, pages_per_slot=64, n_slots=4)
_CACHE = {}


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _setup(arch):
    """(reference bf16 cfg, reference f32 cfg, reference bf16 params, their
    f32 copies, port bf16 cfg, port bf16 params), drawn once."""
    if arch not in _CACHE:
        bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
        jc32 = jreduced(jget_config(arch), **GEOMETRY[arch])
        jc16 = dataclasses.replace(jc32, **bf16)
        c16 = dataclasses.replace(reduced(get_config(arch), **GEOMETRY[arch]),
                                  **bf16)
        jp16 = jax.tree_util.tree_map(
            np.asarray, jtf.init_params(jc16, jax.random.PRNGKey(0)))
        jp32 = jax.tree_util.tree_map(lambda x: x.astype(np.float32), jp16)
        tp16 = convert.lm_params_from_numpy(jp16, c16, device="cpu")
        _CACHE[arch] = (jc16, jc32, jp16, jp32, c16, tp16)
    return _CACHE[arch]


def _case(kind, cfg, seed):
    """(rows, lengths, active, tokens, pools as bf16-rounded f32 numpy):
    the decode tick has a dead row and a row owning 40 pages; the prefill
    chunk writes 6 of its 8 positions from 900."""
    spec = PageSpec(**SPEC)
    rng = np.random.default_rng(seed)
    pp, n_pages = spec.pages_per_slot, spec.n_pages
    perm = rng.permutation(n_pages)
    if kind == "prefill":
        rows = np.full((1, pp), n_pages, np.int32)
        rows[0, :58] = perm[:58]
        lengths, active, t = np.array([900], np.int32), \
            np.array([6], np.int32), 8
    else:
        rows = perm[:4 * pp].reshape(4, pp).astype(np.int32)
        rows[1, 40:] = n_pages
        rows[2] = n_pages
        lengths = np.array([1000, 627, 0, 1015], np.int32)
        active = np.array([1, 1, 0, 1], np.int32)
        t = 1
    tokens = rng.integers(0, cfg.vocab_size, (rows.shape[0], t)) \
        .astype(np.int32)
    shape = (cfg.n_layers, n_pages, spec.page_len, cfg.n_kv_heads,
             cfg.head_dim)
    pools = {k: _bf16(rng.standard_normal(shape)).astype(np.float32)
             for k in ("k", "v")}
    return rows, lengths, active, tokens, pools


def _reference(jcfg, jparams, store, case, routes=None):
    """The reference's jitted paged step; its logits (f32 numpy) and, with
    ``routes`` a list, each router call's probabilities appended to it."""
    rows, lengths, active, tokens, pools = case
    spec = JPageSpec(**SPEC, store_dtype=store)
    step = jax.jit(jpg.make_serve_step(jcfg, spec, "paged"))
    caches = [{k: jnp.asarray(v, store) for k, v in pools.items()}]
    args = [jnp.asarray(a) for a in (rows, lengths, active, tokens)]
    if routes is None:
        logits, _ = step(jparams, caches, *args)
        return np.asarray(logits, np.float32)
    real = jmoe.router_probs

    def recorded(*a, **kw):
        probs = real(*a, **kw)
        jax.debug.callback(lambda v: routes.append(np.array(v)), probs,
                           ordered=True)
        return probs
    jmoe.router_probs = recorded
    try:
        logits, _ = step(jparams, caches, *args)
        logits = np.asarray(logits, np.float32)
        jax.effects_barrier()
    finally:
        jmoe.router_probs = real
    return logits


def _port(cfg, tparams, case):
    rows, lengths, active, tokens, pools = case
    spec = PageSpec(**SPEC, store_dtype=torch.bfloat16)
    caches = [{k: torch.from_numpy(v).bfloat16() for k, v in pools.items()}]
    logits, _ = pg.make_serve_step(cfg, spec, "paged")(
        tparams, caches, rows, lengths, active, tokens)
    return logits.float().numpy()


def _agreeing(r16, r32, k, n_tokens):
    """Tokens whose top-k experts the two recorded runs choose alike in
    every layer (router call)."""
    same = np.ones(n_tokens, bool)
    assert len(r16) == len(r32) > 0
    for a, b in zip(r16, r32):
        a, b = a.reshape(n_tokens, -1), b.reshape(n_tokens, -1)
        same &= (np.sort(np.argsort(-a, -1, kind="stable")[:, :k], -1)
                 == np.sort(np.argsort(-b, -1, kind="stable")[:, :k], -1)
                 ).all(-1)
    return same


def _gaps(arch, kind, seed=0):
    """(port's gap, the reference's gap, the floor, tokens held, tokens
    routed otherwise) of the bf16 step to the f32 step."""
    jc16, jc32, jp16, jp32, c16, tp16 = _setup(arch)
    case = _case(kind, c16, seed)
    r16, r32 = ([], []) if c16.moe else (None, None)
    want = _reference(jc32, jp32, jnp.float32, case, r32)
    ref = _reference(jc16, jp16, jnp.bfloat16, case, r16)
    got = _port(c16, tp16, case)
    n = want.shape[0] * want.shape[1]
    held = (_agreeing(r16, r32, c16.moe.top_k, n) if c16.moe
            else np.ones(n, bool))
    per = lambda x: np.abs(x - want).reshape(n, -1).max(-1)[held].max()
    floor = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return per(got), per(ref), floor, int(held.sum()), int((~held).sum())


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", list(GEOMETRY))
def test_bf16_step_within_the_references_own_bf16_gap(arch, kind):
    port, ref, floor, held, flipped = _gaps(arch, kind)
    assert held >= (1 - MAX_FLIPPED) * (held + flipped)
    assert port <= max(BAND_TIMES * ref, floor), (port, ref, floor, flipped)


def _rope_in_bf16(positions, hd, theta):
    """A planted fault: ``rope_tables`` with the angles computed in bf16."""
    freqs = torch.from_numpy(layers.rope_freqs(hd, theta)).bfloat16()
    ang = (positions[..., None].bfloat16() * freqs).float()
    sign = torch.from_numpy(np.repeat(np.float32([-1.0, 1.0]), hd // 2))
    return (layers._tile2_last(torch.cos(ang)[..., None, :], hd),
            layers._tile2_last(torch.sin(ang)[..., None, :], hd) * sign)


def _other_kv_head(real):
    """A planted fault: each group of query heads reads the other KV
    head."""
    return lambda k, n_rep: real(torch.roll(k, 1, dims=2), n_rep)


@pytest.mark.parametrize("fault", ["rope_in_bf16", "other_kv_head"])
@pytest.mark.parametrize("arch", list(GEOMETRY))
def test_planted_faults_leave_the_bf16_band(arch, fault, monkeypatch):
    if fault == "rope_in_bf16":
        monkeypatch.setattr(pg, "rope_tables", _rope_in_bf16)
    else:
        monkeypatch.setattr(pg, "gqa_expand", _other_kv_head(pg.gqa_expand))
    port, ref, floor, _, _ = _gaps(arch, "decode")
    assert port > max(BAND_TIMES * ref, floor), (port, ref, floor)
