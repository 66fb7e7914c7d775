"""The port's LM training path against the JAX package's, on the CPU.

Reduced f32 configs — ``phi3-mini-3.8b``, ``gemma3-4b`` (sliding window
16), ``zamba2-2.7b`` at 6 layers (so its weight-tied shared attention
block runs) and ``rwkv6-7b`` — with the reference's ``init_params``
carried over through ``convert.lm_params_from_numpy`` and the same numpy
tokens in both packages.

Tolerances, each a few times the gap measured on this CPU:

* ``LOSS_ATOL`` 1e-5 on a loss of about 6.8 (measured <= 9.5e-7);
* ``GRAD_RTOL`` 5e-5 of each leaf's largest reference gradient, per
  element (measured <= 8.1e-6, rwkv6; 1.6e-6 zamba2, <= 2.5e-6 phi3 and
  gemma3): the two packages run the same scans in f32 with other matmul
  and reduction orders;
* the optimizer updates are elementwise in the reference's float order
  and held bit for bit where they see the same inputs (AdamW, below);
* ``STEP_ATOL`` 1e-6 on params after SGD-type steps at lr 5e-3 (measured
  3e-8 micro step; engine runs below).

An AdamW step is ill-conditioned where a gradient lies near 0 (the first
step moves each weight by about ``lr * g / (|g| + eps)``, so a rounding
difference in a gradient of 1e-8 moves the weight by up to ``lr``): one
train step is held on its loss and moments, and its update as the
reference optimizer's update of the port's own gradients, bit for bit.
"""
import argparse
from dataclasses import replace

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
from repro.core.spmd_dual_batch import SpmdDualBatch as JSpmdDualBatch
from repro.core.spmd_dual_batch import make_micro_train_step as jmake_micro
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.engine.engine import TrainEngine as JTrainEngine
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import build_spec as jbuild_spec
from repro.models.layers import chunked_cross_entropy as jchunked_ce
from repro.optim import adamw as jadamw
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch import models
from repro_torch.api import RunConfig, run
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.core.spmd_dual_batch import SpmdDualBatch
from repro_torch.core.spmd_dual_batch import make_micro_train_step
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import DataPlane, SyntheticTokens
from repro_torch.engine import TrainEngine
from repro_torch.engine.steps import _value_and_grad
from repro_torch.kernels import dbl_merge as K
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers
from repro_torch.models.transformer import _layer_seed
from repro_torch.optim import adamw, sgd_momentum

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_RTOL = 5e-5
STEP_ATOL = 1e-6
ARCHS = [("phi3-mini-3.8b", 2), ("gemma3-4b", 2), ("zamba2-2.7b", 6),
         ("rwkv6-7b", 2)]
_CACHE = {}


def _setup(arch, layers_=2, **kw):
    """(port cfg, JAX cfg, JAX params, port params), cached."""
    key = (arch, layers_, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg = jreduced(jget_config(arch), layers=layers_, **kw)
        cfg = reduced(get_config(arch), layers=layers_, **kw)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")
        _CACHE[key] = (cfg, jcfg, jp, tp)
    return _CACHE[key]


def _batches(vocab, b=4, s=32, seed=1, weight=None):
    """The same numpy batch for both packages: (JAX batch, port batch)."""
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    jb = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]).long(),
          "labels": torch.from_numpy(tok[:, 1:]).long()}
    if weight is not None:
        w = np.asarray(weight, np.float32)
        jb["weight"], tb["weight"] = jnp.asarray(w), torch.from_numpy(w)
    return jb, tb


def _grads(tp, cfg, batch, **kw):
    """(loss, grads tree) of the port's loss w.r.t. every leaf."""
    leaves, treedef = tree_flatten(tp)
    xs = [l.detach().requires_grad_() for l in leaves]
    loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, batch, **kw)
    return loss.detach(), tree_unflatten(treedef,
                                         list(torch.autograd.grad(loss, xs)))


def _assert_grads_close(jgrads, tgrads):
    jl, tl = jax.tree_util.tree_leaves(jgrads), tree_leaves(tgrads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        gap = float(np.abs(a - b.numpy()).max())
        assert gap <= GRAD_RTOL * float(np.abs(a).max()) + 1e-9, gap


def _gap(jtree, ttree) -> float:
    return max(float(np.abs(np.asarray(a) - b.detach().numpy()).max())
               for a, b in zip(jax.tree_util.tree_leaves(jtree),
                               tree_leaves(ttree)))


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("arch,layers_", ARCHS)
def test_loss_and_grads_match_reference(arch, layers_, weighted):
    cfg, jcfg, jp, tp = _setup(arch, layers_)
    weight = [1.0, 0.5, 0.9365079, 0.0] if weighted else None
    jb, tb = _batches(cfg.vocab_size, weight=weight)
    (jloss, jmet), jgrads = jax.value_and_grad(
        jmodels.loss_fn, has_aux=True)(jp, jcfg, jb)
    loss, grads = _grads(tp, cfg, tb)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _, met = models.loss_fn(tp, cfg, tb)
    np.testing.assert_allclose(met["per_example"].detach().numpy(),
                               np.asarray(jmet["per_example"]),
                               atol=LOSS_ATOL)
    _assert_grads_close(jgrads, grads)


def test_big_vocab_loss_takes_the_chunked_ce():
    """A vocabulary of 65536 (rwkv6-7b's) takes the chunked CE in both
    packages: loss and gradients agree, and equal the dense CE's."""
    cfg, jcfg, jp, tp = _setup("phi3-mini-3.8b", 1, d_model=64, n_heads=2,
                               vocab=65536)
    jb, tb = _batches(cfg.vocab_size, b=2, s=8, weight=[1.0, 0.5])
    (jloss, _), jgrads = jax.value_and_grad(
        jmodels.loss_fn, has_aux=True)(jp, jcfg, jb)
    loss, grads = _grads(tp, cfg, tb)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    _assert_grads_close(jgrads, grads)
    logits = models.forward(tp, cfg, tb["tokens"])
    dense = layers.cross_entropy(logits, tb["labels"])
    dense = (dense * tb["weight"]).sum() / tb["weight"].sum()
    assert abs(float(loss) - float(dense)) <= LOSS_ATOL


@pytest.mark.parametrize("chunk", [4, 7, 8192])
def test_chunked_cross_entropy_matches_dense_and_reference(chunk):
    rng = np.random.default_rng(5)
    b, s, d, v = 2, 12, 16, 50
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    head = rng.normal(size=(v, d)).astype(np.float32)
    lab = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    th, thead = (torch.from_numpy(a).requires_grad_() for a in (h, head))
    tl, tm = torch.from_numpy(lab).long(), torch.from_numpy(mask)
    got = layers.chunked_cross_entropy(th, thead, tl, chunk=chunk,
                                       label_mask=tm)
    dense = layers.cross_entropy(torch.einsum("bsd,vd->bsv", th, thead), tl,
                                 tm)
    ref = np.asarray(jchunked_ce(jnp.asarray(h), jnp.asarray(head),
                                 jnp.asarray(lab), chunk=chunk,
                                 label_mask=jnp.asarray(mask)))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(),
                               atol=1e-5)
    # under autograd the chunks are recomputed in the backward: the same
    # gradients as the dense form
    g1 = torch.autograd.grad(got.sum(), (th, thead))
    g2 = torch.autograd.grad(dense.sum(), (th, thead))
    for a, b_ in zip(g1, g2):
        torch.testing.assert_close(a, b_, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------- remat and dropout
@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("arch,layers_", [("phi3-mini-3.8b", 2),
                                          ("zamba2-2.7b", 6),
                                          ("rwkv6-7b", 2)])
def test_remat_gives_the_same_gradients(arch, layers_, remat):
    cfg, _, _, tp = _setup(arch, layers_)
    _, tb = _batches(cfg.vocab_size, b=2, s=16)
    loss0, g0 = _grads(tp, cfg, tb)
    loss1, g1 = _grads(tp, replace(cfg, remat=remat), tb)
    assert torch.equal(loss0, loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_dropout_statistics_and_layer_seeds():
    """Dropout bits cannot match JAX's threefry, so rate 0 is held to the
    reference (above) and rate > 0 to the dropout's statistics: the kept
    share and scale, the mask repeating for one step generator (and under
    remat, which recomputes it), other steps drawing other masks."""
    x = torch.ones(200_000)
    y = layers.dropout(x, torch.Generator().manual_seed(0), 0.3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert layers.dropout(x, None, 0.3) is x

    cfg, _, _, tp = _setup("phi3-mini-3.8b", 2)
    _, tb = _batches(cfg.vocab_size, b=2, s=16)
    gen = lambda s: torch.Generator().manual_seed(s)
    kw = dict(drop_rate=0.5)
    base = models.forward(tp, cfg, tb["tokens"])
    a = models.forward(tp, cfg, tb["tokens"], drop_rng=gen(3), **kw)
    b = models.forward(tp, cfg, tb["tokens"], drop_rng=gen(3), **kw)
    c = models.forward(tp, cfg, tb["tokens"], drop_rng=gen(4), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, base)
    # the two layers draw different masks from one step generator
    seeds = {_layer_seed(gen(3), li) for li in range(cfg.n_layers)}
    assert len(seeds) == cfg.n_layers
    _, g0 = _grads(tp, cfg, tb, drop_rng=gen(3), **kw)
    _, g1 = _grads(tp, replace(cfg, remat="block"), tb, drop_rng=gen(3),
                   **kw)
    for u, v in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(u, v, atol=1e-7, rtol=1e-6)


# ------------------------------------------------------------------ steps
def test_adamw_steps_bit_equal_to_reference():
    """AdamW's update in the reference's float order: the bias corrections
    from an int32 step count in f32 and a correctly rounded square root
    make four steps bit-equal to the reference's eager update (the bias
    corrections in double were off by an ulp)."""
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(64, 33)).astype(np.float32) * 0.05,
         "b": [rng.normal(size=(100,)).astype(np.float32)]}
    jo, to = jadamw(weight_decay=0.01), adamw(weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
    for _ in range(4):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.01, p)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                           3e-3)
        tp, ts = to.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                           tp, 3e-3)
        for jt, tt in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
            assert _gap(jt, tt) == 0.0
    assert int(ts["t"]) == int(js["t"]) == 4


def test_train_step_matches_reference():
    """One weighted AdamW ``make_train_step`` step: the loss and moments
    against the reference's step, and the update as the reference
    optimizer's update of the port's own gradients, bit for bit."""
    cfg, jcfg, jp, tp = _setup("phi3-mini-3.8b", 2)
    jb, tb = _batches(cfg.vocab_size, b=8, s=16, seed=2,
                      weight=[1, 1, 1, 1, .9, .9, 0, 0])
    jo, to = jadamw(weight_decay=0.01), adamw(weight_decay=0.01)
    js0 = jo.init(jp)
    ts0 = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js0), "cpu")
    jp1, js1, jloss = jmake_train_step(jcfg, jo)(jp, js0, jb, 3e-3)
    tp1, ts1, loss = make_train_step(cfg, to)(tp, ts0, tb, 3e-3)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    for jt, tt in ((js1["m"], ts1["m"]), (js1["v"], ts1["v"])):
        for a, b in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
            a = np.asarray(a)
            assert float(np.abs(a - b.numpy()).max()) <= \
                GRAD_RTOL * float(np.abs(a).max()) + 1e-12
    assert int(ts1["t"]) == 1 and ts1["t"].dtype == torch.int32
    _, grads = _value_and_grad(tp, cfg, tb, None, 0.0)
    want, _ = jo.update(jax.tree_util.tree_map(lambda t: jnp.asarray(
        t.numpy()), grads), js0, jp, 3e-3)
    assert _gap(want, tp1) == 0.0


def test_micro_step_matches_reference():
    cfg, jcfg, jp, tp = _setup("phi3-mini-3.8b", 2)
    jb, tb = _batches(cfg.vocab_size, b=8, s=16, seed=2)
    lay = dict(global_batch=8, n_workers=4, n_small=2, small_valid=1,
               factor_small=0.8)
    jo, to = jsgd_momentum(0.9), sgd_momentum(0.9)
    js0 = jo.init(jp)
    ts0 = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js0), "cpu")
    jp1, js1, jmet = jmake_micro(jcfg, jo, layout=JSpmdDualBatch(**lay),
                                 micro_steps=2)(jp, js0, jb, 5e-3)
    tp1, ts1, met = make_micro_train_step(cfg, to, layout=SpmdDualBatch(
        **lay), micro_steps=2)(tp, ts0, tb, 5e-3)
    for k in ("loss", "loss_small"):
        assert abs(float(met[k]) - float(jmet[k])) <= LOSS_ATOL
    assert _gap(jp1, tp1) <= STEP_ATOL
    _assert_grads_close(js1["v"], ts1["v"])


# --------------------------------------------------- the engine, end to end
def _cli_args(**kw):
    base = dict(scheme="dbl", seq=16, global_batch=8, steps=4, lr=5e-3,
                k=1.05, n_small=3, micro_steps=0, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("form", ["fused", "per_step", "micro"])
def test_engine_runs_match_reference(form):
    """A few engine steps on reduced phi3-mini through both packages'
    ``api.run`` on the same DataPlane streams: the fused SGD path (one
    ``dbl_apply_flat2d`` a step; its plain form on the CPU), the per-step
    loop (``dbl_merge_flat2d``) and the micro-update mode."""
    cfg, jcfg, jp, tp = _setup("phi3-mini-3.8b", 2)
    args = _cli_args(micro_steps=2 if form == "micro" else 0)
    jspec = jbuild_spec(args)
    spec = train.build_spec(args)
    assert spec.to_json() == jspec.to_json()
    mom = 0.9 if form == "micro" else 0.0
    jopt, opt = jsgd_momentum(mom), sgd_momentum(mom)
    sgd_server = form != "micro"
    scan = form == "fused"
    jeng = JTrainEngine(jcfg, jopt, sgd_server=sgd_server, interpret=True,
                        scan_loop="auto" if scan else False)
    eng = TrainEngine(cfg, opt, sgd_server=sgd_server, device="cpu",
                      scan_loop="auto" if scan else False)
    data = dict(vocab=min(cfg.vocab_size, 256), seed=0, n_examples=512)
    jres = jrun(jspec, JRunConfig(backend="spmd", log_every=1),
                init_params=jax.tree_util.tree_map(jnp.copy, jp),
                engine=jeng, plane=JDataPlane(JSyntheticTokens(**data),
                                              seed=0))
    K.reset_counts()
    res = run(spec, RunConfig(backend="spmd", log_every=1), init_params=tp,
              engine=eng, plane=DataPlane(SyntheticTokens(**data), seed=0))
    plain = {"fused": ("dbl_apply_flat2d", 4), "per_step":
             ("dbl_merge_flat2d", 4), "micro": (None, 0)}[form]
    assert K.plain_count() == plain[1] and K.launch_count() == 0
    if plain[0]:
        assert K.plain_count(plain[0]) == plain[1]
    jl = [h["loss"] for h in jres.history]
    tl = [h["loss"] for h in res.history]
    assert len(tl) == len(jl) == 4
    # the history rounds losses to 4 decimals: one unit apart at most
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= 1.5e-4
    assert _gap(jres.params, res.params) <= STEP_ATOL


def test_short_training_run_reduces_loss():
    """The reference's ``test_system.py`` check on the port's CLI (the
    dbl scheme at lr 5e-3), at 20 steps: the records of steps 1 and 20."""
    hist = train.run(["--arch", "phi3-mini-3.8b", "--steps", "20",
                      "--scheme", "dbl", "--seq", "32", "--global-batch",
                      "16", "--lr", "5e-3", "--device", "cpu"])
    assert [h["step"] for h in hist] == [1, 20]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_hybrid_scheme_runs_both_substages():
    """The reference's ``test_system.py`` check at 20 steps, the fewest
    that log a step of each sub-stage (steps 1 and 20)."""
    hist = train.run(["--arch", "gemma3-4b", "--steps", "20", "--scheme",
                      "hybrid", "--seq", "32", "--global-batch", "8",
                      "--device", "cpu"])
    assert len({h["seq"] for h in hist}) == 2
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_cli_fences_and_build_spec():
    """The reference's CLI rules: ``build_spec`` equal field for field,
    ``--resume`` needs ``--ckpt``, ``--server-momentum`` only on the fused
    dual-batch SGD path."""
    for kw in ({}, {"scheme": "hybrid", "seq": 128},
               {"scheme": "baseline", "micro_steps": 2}):
        args = _cli_args(**kw)
        assert train.build_spec(args).to_json() == \
            jbuild_spec(args).to_json()
    for argv in (["--resume"],
                 ["--server-momentum", "0.9"],
                 ["--optimizer", "sgd", "--server-momentum", "0.9",
                  "--no-scan-loop"]):
        with pytest.raises(SystemExit):
            train.run(argv + ["--device", "cpu"])
