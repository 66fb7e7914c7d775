"""The MoE family on every LM path of the port against the JAX package's,
on the CPU.

Reduced ``granite-moe-3b-a800m`` keeps granite's attention geometry:
``reduced(cfg, d_model=384, n_heads=6)`` gives 6 query heads over 2 KV
heads of 64 (n_rep 3, as the full model's 24 / 8) and 4 experts, top-2,
in f32, with the reference's ``init_params`` carried over by
``convert.lm_params_from_numpy`` and the same numpy tokens in both
packages.

Routing is discontinuous: a token whose k-th and (k+1)-th gates lie
within rounding of each other may choose another expert in the other
package.  Each path records both packages' router probabilities (the
reference's through ordered ``jax.debug.callback``s, so under jit, scan
and grad) and holds the routes
with ``_assert_same_routes``: the same experts in the same order, or,
where they differ, a near-tie in the reference's gates (``NEAR_TIE``).

Bands, each a few times the gap measured on this CPU:

* ``LOGIT_BAND`` 5e-5 on forward, decode and serving logits (magnitude
  about 4; measured <= 6.2e-6 forward, 5.7e-6 generate, 6.7e-6 serve);
  ``AUX_TOL`` 1e-6 on the aux loss of about 2.3 (measured 0);
* ``LOSS_ATOL`` 1e-5 on the loss (measured 0), ``GRAD_RTOL`` 5e-5 of each
  leaf's largest reference gradient (measured <= 2.0e-6, router
  included), as ``tests/test_torch_lm_train.py`` holds the dense LMs;
* ``STEP_ATOL`` 1e-6 on params after 4 fused SGD engine steps (measured
  1.5e-8), the history's losses one rounding unit (1e-4) apart at most
  (measured equal).
"""
import argparse
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.api import RunConfig as JRunConfig
from repro.api import run as jrun
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.engine.engine import TrainEngine as JTrainEngine
from repro.launch.serve import generate as jgenerate
from repro.launch.train import build_spec as jbuild_spec
from repro.models import moe as jmoe
from repro.optim import sgd_momentum as jsgd_momentum
from repro.serve import PageSpec as JPageSpec
from repro.serve import ServeEngine as JServeEngine
from repro.serve import synthetic_workload as jsynthetic
from repro_torch import models
from repro_torch.api import RunConfig, run
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import DataPlane, SyntheticTokens
from repro_torch.engine import TrainEngine
from repro_torch.kernels import dbl_merge as K
from repro_torch.launch import serve, train
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import moe
from repro_torch.optim import sgd_momentum
from repro_torch.serve import PageSpec, ServeEngine, synthetic_workload

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
GEOMETRY = dict(d_model=384, n_heads=6)
LOGIT_BAND = 5e-5
AUX_TOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_RTOL = 5e-5
STEP_ATOL = 1e-6
NEAR_TIE = 1e-5
PROMPT, GEN, BATCH = 20, 6, 2
CHURN_SPEC = dict(page_len=16, pages_per_slot=4, n_slots=2)
_CACHE = {}


def _setup():
    """(port cfg, JAX cfg, JAX params, port params), cached."""
    if "setup" not in _CACHE:
        jcfg = jreduced(jget_config(ARCH), **GEOMETRY)
        cfg = reduced(get_config(ARCH), **GEOMETRY)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")
        _CACHE["setup"] = (cfg, jcfg, jp, tp)
    return _CACHE["setup"]


def _tokens(shape, seed=1):
    vocab = _setup()[0].vocab_size
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


@contextlib.contextmanager
def _routes(monkeypatch):
    """Record every router call of both packages: yields (port, reference)
    lists of (tokens, E') probability arrays, in call order."""
    got, want = [], []

    def keep(out, probs):
        out.append(np.array(probs).reshape(-1, probs.shape[-1]))

    def recorder(mod, out, jax_side):
        real = mod.router_probs

        def rec(*a, **kw):
            probs = real(*a, **kw)
            if jax_side:      # the values, under jit, scan and grad too
                jax.debug.callback(lambda v: keep(out, v), probs,
                                   ordered=True)
            else:
                keep(out, probs.detach())
            return probs
        monkeypatch.setattr(mod, "router_probs", rec)
    recorder(moe, got, False)
    recorder(jmoe, want, True)
    yield got, want
    monkeypatch.undo()


def _assert_same_routes(got, want, k):
    """Both packages ranked the same top-k experts in the same order at
    every token, except where the reference's gates at the first rank
    that differs lie within ``NEAR_TIE`` of the next one."""
    assert len(got) == len(want) > 0
    near = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        ia = np.argsort(-a, axis=-1, kind="stable")[:, :k]
        ib = np.argsort(-b, axis=-1, kind="stable")[:, :k]
        for row in np.flatnonzero((ia != ib).any(-1)):
            r = int(np.flatnonzero(ia[row] != ib[row])[0])
            s = np.sort(b[row])[::-1]
            assert s[r] - s[r + 1] <= NEAR_TIE, (row, r, s[:k + 1])
            near += 1
    return near


def _gap(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


# ------------------------------------------------------------- the registry
def test_granite_is_registered_with_the_reference_config():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert ARCH in ARCH_IDS
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "head_dim", "arch_type", "source"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.moe) == vars(jcfg.moe)
    assert (cfg.moe.capacity_factor, cfg.moe.router_aux_weight,
            cfg.moe.dispatch_group) == (1.25, 0.01, 512)
    assert cfg.param_count() == jcfg.param_count() == 3_374_294_016
    assert cfg.active_param_count() == 958_374_912
    assert train.parser().parse_args(["--arch", ARCH]).arch == ARCH


# ---------------------------------------------------------------- init tree
@pytest.mark.parametrize("variant", ["granite", "padded-residual"])
def test_init_tree_matches_reference(variant):
    """Key paths, shapes and dtypes of ``init_params`` equal the
    reference's (the router f32 in a bf16 model too); ``pad_to`` and
    ``dense_residual`` add the padded experts and the ``res_*`` leaves."""
    from dataclasses import replace
    jcfg = jreduced(jget_config(ARCH), **GEOMETRY)
    cfg = reduced(get_config(ARCH), **GEOMETRY)
    if variant == "padded-residual":
        jcfg = replace(jcfg, moe=replace(jcfg.moe, pad_to=6,
                                         dense_residual=True))
        cfg = replace(cfg, moe=replace(cfg.moe, pad_to=6,
                                       dense_residual=True))
    jcfg = replace(jcfg, param_dtype="bfloat16")
    cfg = replace(cfg, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: jmodels.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = models.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    gl, gd = tree_flatten(got)
    wl, wd = jax.tree_util.tree_flatten(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    blk = got["segments"][0]["moe"]
    assert blk["router"].dtype == torch.float32
    assert blk["wi"].shape[1] == cfg.moe.padded_experts
    assert ("res_wi" in blk) == (variant == "padded-residual")
    # and the reference's own tree crosses over leaf for leaf
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              "cpu")
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(t.shape) for t in tree_leaves(got)]


def test_params_carry_over_checks_the_experts():
    from dataclasses import replace
    cfg, _, jp, _ = _setup()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="experts"):
        lm_params_from_numpy(tree, replace(cfg, moe=replace(cfg.moe,
                                                            pad_to=6)), "cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["segments"][0]["moe"]["router"] = \
        bad["segments"][0]["moe"]["router"].astype(np.float16)
    with pytest.raises(ValueError, match="f32"):
        lm_params_from_numpy(bad, cfg, "cpu")


# ------------------------------------------------- forward, loss, gradients
def test_forward_and_aux_match_reference(monkeypatch):
    """Logits and the summed aux loss against ``repro.models.forward(...,
    return_aux=True)``, the routes held; the prefill step's last-position
    logits equal the forward's."""
    cfg, jcfg, jp, tp = _setup()
    tok = _tokens((4, 32))
    with _routes(monkeypatch) as (got_r, want_r):
        jl, jaux = jmodels.forward(jp, jcfg, jnp.asarray(tok),
                                   return_aux=True)
        tl, taux = models.forward(tp, cfg, torch.from_numpy(tok).long(),
                                  return_aux=True)
    _assert_same_routes(got_r, want_r, cfg.moe.top_k)
    assert len(got_r) == cfg.n_layers
    assert _gap(tl.detach(), jl) <= LOGIT_BAND
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert float(taux) > 0
    last = make_prefill_step(cfg)(tp, torch.from_numpy(tok).long())
    assert _gap(last, np.asarray(jl)[:, -1]) <= LOGIT_BAND


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_loss_and_grads_match_reference(weighted):
    """``loss_fn`` (CE plus ``router_aux_weight * aux / n_layers``) and its
    gradients, router included, against ``jax.value_and_grad`` of the
    reference's; the routes of this batch are the forward test's."""
    cfg, jcfg, jp, tp = _setup()
    tok = _tokens((4, 33))
    jb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]).long(),
          "labels": torch.from_numpy(tok[:, 1:]).long()}
    if weighted:
        w = np.float32([1.0, 0.5, 0.9365079, 0.0])
        jb["weight"], tb["weight"] = jnp.asarray(w), torch.from_numpy(w)
    (jloss, _), jg = jax.value_and_grad(jmodels.loss_fn, has_aux=True)(
        jp, jcfg, jb)
    leaves, treedef = tree_flatten(tp)
    xs = [t.detach().requires_grad_() for t in leaves]
    loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, tb)
    grads = torch.autograd.grad(loss, xs)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for a, b in zip(jleaves, grads):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert _gap(b, a) <= GRAD_RTOL * float(np.abs(a).max()) + 1e-9
    router = tree_unflatten(treedef, list(grads))["segments"][0]["moe"][
        "router"]
    assert float(router.abs().max()) > 0
    # the aux term: the loss minus the CE is the reference's aux term
    _, jaux = jmodels.forward(jp, jcfg, jb["tokens"], return_aux=True)
    ce = float(jloss) - cfg.moe.router_aux_weight * float(jaux) / cfg.n_layers
    with torch.no_grad():
        dense = models.loss_fn(tp, cfg, tb)[0] - cfg.moe.router_aux_weight \
            * models.forward(tp, cfg, tb["tokens"], return_aux=True)[1] \
            / cfg.n_layers
    assert abs(float(dense) - ce) <= LOSS_ATOL


def test_aux_gradient_alone_reaches_the_router():
    """The load-balance term's own gradient w.r.t. the router against
    ``jax.grad`` of the reference's aux (the CE's part removed)."""
    cfg, jcfg, jp, tp = _setup()
    tok = _tokens((2, 16), seed=4)
    jg = jax.grad(lambda p: jmodels.forward(p, jcfg, jnp.asarray(tok),
                                            return_aux=True)[1])(jp)
    leaves, treedef = tree_flatten(tp)
    xs = [t.detach().requires_grad_() for t in leaves]
    _, aux = models.forward(tree_unflatten(treedef, xs), cfg,
                            torch.from_numpy(tok).long(), return_aux=True)
    grads = tree_unflatten(treedef, list(torch.autograd.grad(
        aux, xs, allow_unused=True)))
    a = np.asarray(jg["segments"][0]["moe"]["router"])
    b = grads["segments"][0]["moe"]["router"]
    assert float(np.abs(a).max()) > 0
    assert _gap(b, a) <= GRAD_RTOL * float(np.abs(a).max())


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("stepped", [False, True], ids=["chunked", "stepped"])
def test_generate_matches_reference(stepped, monkeypatch):
    """Greedy tokens identical to the reference's ``generate`` (dropless
    MoE in every decode step), the generated tokens' logits within
    ``LOGIT_BAND`` of the reference's stepped decode, the routes held."""
    cfg, jcfg, jp, tp = _setup()
    tok = _tokens((BATCH, PROMPT))
    with _routes(monkeypatch) as (got_r, want_r):
        want = np.asarray(jgenerate(jcfg, jp, jnp.asarray(tok), gen=GEN,
                                    max_seq=PROMPT + GEN,
                                    stepped_prefill=stepped))
        got, logits = serve.generate(cfg, tp, torch.from_numpy(tok).long(),
                                     gen=GEN, max_seq=PROMPT + GEN,
                                     stepped_prefill=stepped,
                                     return_logits=True)
    _assert_same_routes(got_r, want_r, cfg.moe.top_k)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want[:, PROMPT:])
    # the logits against the reference's decode steps on the same tokens
    jc = jmodels.init_cache(jcfg, BATCH, PROMPT + GEN)
    jl, jc = jmodels.decode_step(jp, jcfg, jc, jnp.asarray(want[:, :PROMPT]),
                                 jnp.int32(0))
    ref = [np.asarray(jl[:, -1])]
    for t in range(PROMPT, PROMPT + GEN - 1):
        jl, jc = jmodels.decode_step(jp, jcfg, jc, jnp.asarray(
            want[:, t:t + 1]), jnp.int32(t))
        ref.append(np.asarray(jl[:, -1]))
    assert _gap(logits, np.stack(ref, 1)) <= LOGIT_BAND


# ------------------------------------------------------------------ serving
def _churn(vocab, seed=1, n=8):
    kw = dict(prompt_lens=(3, 20), gen_short=(3, 8), gen_long=(12, 20),
              p_long=0.3)
    return (synthetic_workload(seed, n, vocab=vocab, **kw),
            jsynthetic(seed, n, vocab=vocab, **kw))


@pytest.mark.parametrize("backend", ["paged", "contig"])
def test_serve_engine_matches_reference(backend, monkeypatch):
    """``ServeEngine`` on the churn workload of the reference's serving
    tests: the schedule, greedy tokens and counters equal, logits within
    ``LOGIT_BAND``, the routes held, each emitted token's top-2 logit
    margin above the measured gap."""
    cfg, jcfg, jp, tp = _setup()
    reqs, jreqs = _churn(cfg.vocab_size)
    kw = dict(backend=backend, record_logits=True, prefill_chunk=8)
    with _routes(monkeypatch) as (got_r, want_r):
        je = JServeEngine(jcfg, jp, spec=JPageSpec(**CHURN_SPEC), **kw)
        jr = je.serve(jreqs)
        te = ServeEngine(cfg, tp, spec=PageSpec(**CHURN_SPEC), device="cpu",
                         **kw)
        tr = te.serve(reqs)
    _assert_same_routes(got_r, want_r, cfg.moe.top_k)
    assert te.log == je.log
    assert {r.rid: tuple(r.tokens) for r in tr} == \
        {r.rid: tuple(r.tokens) for r in jr}
    gap = max(_gap(x, y) for a, b in zip(jr, tr)
              for x, y in zip(a.logits, b.logits))
    margin = min(float(np.diff(np.sort(y)[-2:])[0]) for b in tr
                 for y in b.logits)
    assert gap <= LOGIT_BAND and margin > gap
    assert te.stats == je.stats


# ----------------------------------------------------------------- training
def test_engine_steps_match_reference(monkeypatch):
    """Four fused dual-batch SGD steps (one ``dbl_apply_flat2d`` a step;
    its plain form on the CPU) through both packages' ``api.run`` on the
    same DataPlane streams: losses and params, the routes held."""
    cfg, jcfg, jp, tp = _setup()
    args = argparse.Namespace(scheme="dbl", seq=16, global_batch=8, steps=4,
                              lr=5e-3, k=1.05, n_small=3, micro_steps=0,
                              seed=0)
    jspec, spec = jbuild_spec(args), train.build_spec(args)
    assert spec.to_json() == jspec.to_json()
    data = dict(vocab=min(cfg.vocab_size, 256), seed=0, n_examples=512)
    with _routes(monkeypatch) as (got_r, want_r):
        jres = jrun(jspec, JRunConfig(backend="spmd", log_every=1),
                    init_params=jax.tree_util.tree_map(jnp.copy, jp),
                    engine=JTrainEngine(jcfg, jsgd_momentum(0.0),
                                        sgd_server=True, interpret=True,
                                        scan_loop="auto"),
                    plane=JDataPlane(JSyntheticTokens(**data), seed=0))
        K.reset_counts()
        res = run(spec, RunConfig(backend="spmd", log_every=1),
                  init_params=tp,
                  engine=TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True,
                                     device="cpu", scan_loop="auto"),
                  plane=DataPlane(SyntheticTokens(**data), seed=0))
    assert K.plain_count("dbl_apply_flat2d") == 4 and K.launch_count() == 0
    jl = [h["loss"] for h in jres.history]
    tl = [h["loss"] for h in res.history]
    assert len(tl) == len(jl) == 4
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= 1.5e-4
    assert max(_gap(b.detach(), a) for a, b in zip(
        jax.tree_util.tree_leaves(jres.params),
        tree_leaves(res.params))) <= STEP_ATOL
    # both packages route each step's forwards in the same order; the
    # reference's backward may re-run its forward under remat, so compare
    # the port's calls with the reference's of the same shapes in order
    _assert_same_routes(*_matched_calls(got_r, want_r), cfg.moe.top_k)


def _matched_calls(got, want):
    """The reference's calls matched one to one with the port's: the
    first unused reference call of the same values' shape, in order,
    whose top-1 routes agree at most tokens (a re-run of an earlier
    forward, as remat makes, is skipped)."""
    used, pairs = set(), []
    for a in got:
        for j, b in enumerate(want):
            if j in used or b.shape != a.shape:
                continue
            if np.mean(a.argmax(-1) == b.argmax(-1)) > 0.9 and \
                    np.abs(a - b).max() < 1e-3:
                used.add(j)
                pairs.append((a, b))
                break
        else:
            raise AssertionError(f"no reference router call matches a port "
                                 f"call of shape {a.shape}")
    return [p[0] for p in pairs], [p[1] for p in pairs]


def test_training_cli_runs_granite():
    """``launch.train.run`` on reduced granite, hybrid dual-batch x CPL
    with fused SGD: both sequence lengths, finite losses."""
    hist = train.run(["--arch", ARCH, "--steps", "20", "--scheme", "hybrid",
                      "--optimizer", "sgd", "--seq", "32",
                      "--global-batch", "8", "--device", "cpu"])
    assert len({h["seq"] for h in hist}) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)
