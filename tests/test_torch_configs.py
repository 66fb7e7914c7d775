"""The remaining configs and the input shapes against the JAX package, on
the CPU: the registry (``configs/__init__.py``, the four configs of
llama3-405b, deepseek-67b, arctic-480b and chameleon-34b), the shapes
(``configs/shapes.py``), ``launch/specs.py`` (``effective_window``,
``input_specs``, ``abstract_params``) and the window override of
``launch/steps.py``; then the four models at a reduced size through the
port's entry points.

The abstract trees are the reference's ``jax.eval_shape`` trees: the same
key paths, shapes and dtypes, every leaf a meta tensor (no storage).

The reduced four keep their attention geometry's group width: 16 query
heads over one KV head (llama3's n_rep 16), 8 over 1 (deepseek,
chameleon) and 7 over 1 (arctic, with 4 experts, top-2 and the dense
residual), at head dim 16, in f32, with the reference's ``init_params``
carried over by ``convert.lm_params_from_numpy`` and the same numpy
tokens in both packages.  Tolerances, each a few times the gap measured
on this CPU (both packages run the same f32 math in other matmul and
reduction orders):

* ``BAND`` 1e-4 on logits of magnitude about 4, on the loss and on the
  params and momentum after one SGD-momentum step (measured <= 5.9e-6
  on logits, <= 2.7e-7 on params, <= 5.3e-6 on the momentum);
* ``GRAD_RTOL`` 5e-5 of each leaf's largest reference gradient, per
  element (measured <= 3.3e-6), as ``tests/test_torch_lm_train.py``
  holds the other LMs.

The windowed decode (a ``long_500k``-named shape of 64 positions with
``attn_window_override`` 16) runs ``make_decode_step(cfg, shape)`` in
both packages on llama3, phi3, granite and seamless: the same logits
within ``BAND`` (measured <= 5.8e-6), and other logits than the
unwindowed step's (3.3-5.6 apart).
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import InputShape as JInputShape
from repro.launch import specs as jspecs
from repro.models import encdec as jencdec
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.steps import with_window_override as jwith_window_override
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch import models
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.configs import reduced
from repro_torch.configs.base import InputShape
from repro_torch.convert import (encdec_params_from_numpy,
                                 lm_params_from_numpy, opt_state_from_numpy)
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.launch import specs, train
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, with_window_override)
from repro_torch.models import encdec
from repro_torch.optim import sgd_momentum

torch.set_num_threads(1)

NEW = ("llama3-405b", "deepseek-67b", "arctic-480b", "chameleon-34b")
CONFIGS = ARCH_IDS + ("cifar-resnet18",)
# reduced geometry keeping n_rep (16 / 8 / 7 query heads over one KV head)
# at head dim 16
GEOMETRY = {"llama3-405b": dict(n_heads=16, d_model=256),
            "deepseek-67b": dict(n_heads=8, d_model=128),
            "chameleon-34b": dict(n_heads=8, d_model=128),
            "arctic-480b": dict(n_heads=7, d_model=112)}
N_REP = {"llama3-405b": 16, "deepseek-67b": 8, "chameleon-34b": 8,
         "arctic-480b": 7}
BAND = 1e-4
GRAD_RTOL = 5e-5
BATCH, PROMPT, GEN = 2, 12, 4
# the windowed decode: a long_500k-named shape of 64 positions, window 16
WINDOW = 16
LONG = dict(name="long_500k", seq_len=64, global_batch=BATCH, kind="decode")
WINDOW_ARCHS = ("llama3-405b", "phi3-mini-3.8b", "granite-moe-3b-a800m",
                "seamless-m4t-large-v2")
_CACHE = {}


def _gap(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _port_paths(tree, path=""):
    """(key path, leaf) in ``tree_flatten``'s order, the path spelled as
    ``jax.tree_util.keystr`` spells it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_paths(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            yield from _port_paths(c, f"{path}[{i}]")
    else:
        yield path, tree


def _signature(tree, port: bool):
    """[(key path, shape, dtype)] of every leaf."""
    if port:
        return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for p, t in _port_paths(tree)]
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# ------------------------------------------------ the registry and shapes
def test_registry_and_shapes_equal_reference():
    assert ARCH_IDS == tuple(JARCH_IDS)
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])
        assert get_shape(name) is s
    assert dataclasses.asdict(SHAPES["long_500k"]) == dict(
        name="long_500k", seq_len=524_288, global_batch=1, kind="decode")
    # the launch CLIs take every id
    assert train.parser().parse_args(["--arch", ARCH_IDS[-1]]).arch \
        == ARCH_IDS[-1]


@pytest.mark.parametrize("arch", NEW)
def test_config_equals_reference(arch):
    """Every field (the MoE config's too), the block layout and the
    analytic parameter counts."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.blocks == jcfg.blocks
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.n_heads // cfg.n_kv_heads == N_REP[arch]
    assert cfg.head_dim == 128
    assert train.parser().parse_args(["--arch", arch]).arch == arch
    r, jr = reduced(cfg, **GEOMETRY[arch]), jreduced(jcfg, **GEOMETRY[arch])
    assert dataclasses.asdict(r) == dataclasses.asdict(jr)
    assert r.n_heads // r.n_kv_heads == N_REP[arch]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_window_override_equals_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    w = specs.effective_window(cfg, SHAPES[shape])
    assert w == jspecs.effective_window(jcfg, JSHAPES[shape])
    got = with_window_override(cfg, SHAPES[shape])
    want = jwith_window_override(jcfg, JSHAPES[shape])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.blocks == want.blocks
    if w and not cfg.encoder_layers:
        assert "attn" not in got.blocks and got.attn_window == w
    else:
        assert got is cfg


# --------------------------------------------------------- abstract trees
@pytest.mark.parametrize("arch", CONFIGS)
def test_abstract_params_equal_reference(arch):
    """Key paths, shapes and dtypes of the reference's
    ``abstract_params``; every leaf on the meta device."""
    tree = specs.abstract_params(get_config(arch))
    assert all(t.is_meta for t in tree_leaves(tree))
    want = jspecs.abstract_params(jget_config(arch))
    assert _signature(tree, True) == _signature(want, False)
    if arch == "llama3-405b":
        assert sum(t.numel() for t in tree_leaves(tree)) == 405_853_388_800


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, shape):
    """Every (config, shape) pair's abstract inputs, the decode cache tree
    and the encoder-decoder's frames included, as the reference's
    ``jax.eval_shape`` trees; every leaf on the meta device."""
    cfg = get_config(arch)
    got = specs.input_specs(cfg, SHAPES[shape])
    assert all(t.is_meta for t in tree_leaves(got))
    want = jspecs.input_specs(jget_config(arch), JSHAPES[shape])
    assert _signature(got, True) == _signature(want, False)
    if cfg.encoder_layers and SHAPES[shape].kind != "decode":
        frames = got["batch"]["frames"] if shape == "train_4k" \
            else got["frames"]
        assert frames.shape == (SHAPES[shape].global_batch,
                                cfg.encoder_seq, cfg.d_model)
        assert frames.dtype == torch.bfloat16


def test_abstract_params_keep_the_generator_rule():
    """The meta route takes ``MetaDraws`` only: a real generator still has
    to live where the params go, and ``MetaDraws`` builds meta tensors
    only."""
    from repro_torch.models.layers import MetaDraws
    cfg = reduced(get_config("llama3-405b"), **GEOMETRY["llama3-405b"])
    with pytest.raises(ValueError, match="draw them where they live"):
        models.init_params(cfg, torch.Generator(), device="meta")
    with pytest.raises(ValueError, match="draw them where they live"):
        models.init_params(cfg, MetaDraws(), device="cpu")
    with pytest.raises(ValueError, match="meta tensors"):
        models.init_params(get_config("cifar-resnet18"), MetaDraws(),
                           device="cpu")


# ----------------------------------------------------------- reduced four
def _setup(arch, **kw):
    """(port cfg, JAX cfg, JAX params, port params), cached."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg = jreduced(jget_config(arch), **kw)
        cfg = reduced(get_config(arch), **kw)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        tp = encdec_params_from_numpy(tree, cfg, "cpu") if cfg.encoder_layers \
            else lm_params_from_numpy(tree, cfg, "cpu")
        _CACHE[key] = (cfg, jcfg, jp, tp)
    return _CACHE[key]


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", NEW)
def test_reduced_prefill_matches_reference(arch):
    """The forward's logits and the prefill step's last-position logits."""
    cfg, jcfg, jp, tp = _setup(arch, **GEOMETRY[arch])
    tok = _tokens(cfg, (BATCH, 24))
    jl = jmodels.forward(jp, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        tl = models.forward(tp, cfg, torch.from_numpy(tok).long())
    assert tl.shape == (BATCH, 24, cfg.vocab_size)
    assert _gap(tl, jl) <= BAND
    last = make_prefill_step(cfg)(tp, torch.from_numpy(tok).long())
    assert _gap(last, np.asarray(jl)[:, -1]) <= BAND


@pytest.mark.parametrize("arch", NEW)
def test_reduced_loss_grads_and_train_step_match_reference(arch):
    """The weighted loss and its gradients against ``jax.value_and_grad``
    of the reference's; then one ``make_train_step`` step with
    ``sgd_momentum(0.9)``: its loss, params and momentum."""
    cfg, jcfg, jp, tp = _setup(arch, **GEOMETRY[arch])
    tok = _tokens(cfg, (BATCH, 17), seed=2)
    w = np.float32([1.0, 0.5])
    jb = {"tokens": jnp.asarray(tok[:, :-1]),
          "labels": jnp.asarray(tok[:, 1:]), "weight": jnp.asarray(w)}
    tb = {"tokens": torch.from_numpy(tok[:, :-1]).long(),
          "labels": torch.from_numpy(tok[:, 1:]).long(),
          "weight": torch.from_numpy(w)}
    (jloss, _), jg = jax.value_and_grad(jmodels.loss_fn, has_aux=True)(
        jp, jcfg, jb)
    leaves, treedef = tree_flatten(tp)
    xs = [t.detach().requires_grad_() for t in leaves]
    loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, tb)
    grads = torch.autograd.grad(loss, xs)
    assert abs(float(loss.detach()) - float(jloss)) <= BAND
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for a, b in zip(jleaves, grads):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert _gap(b, a) <= GRAD_RTOL * float(np.abs(a).max()) + 1e-9

    jo, to = jsgd_momentum(0.9), sgd_momentum(0.9)
    js0 = jo.init(jp)
    ts0 = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js0),
                               "cpu")
    jp1, js1, jloss1 = jax.jit(jmake_train_step(jcfg, jo))(jp, js0, jb, 0.05)
    tp1, ts1, loss1 = make_train_step(cfg, to)(tp, ts0, tb, 0.05)
    assert abs(float(loss1) - float(jloss1)) <= BAND
    for got, want in ((tp1, jp1), (ts1, js1)):
        gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
        assert len(gl) == len(wl)
        assert max(_gap(g, w_) for g, w_ in zip(gl, wl)) <= BAND
    assert max(_gap(g, w_) for g, w_ in zip(
        tree_leaves(tp1), jax.tree_util.tree_leaves(jp))) > 0


@pytest.mark.parametrize("arch", NEW)
def test_reduced_decode_matches_reference(arch):
    """``make_decode_step``: a chunked prompt, then one-token steps on the
    greedy tokens (the first at a host int, the rest at a 0-d tensor
    ``pos``), each step's last-position logits against the reference's
    ``make_decode_step`` on the same tokens."""
    cfg, jcfg, jp, tp = _setup(arch, **GEOMETRY[arch])
    tok = _tokens(cfg, (BATCH, PROMPT), seed=3)
    n = PROMPT + GEN
    jstep = jax.jit(jmake_decode_step(jcfg))
    step = make_decode_step(cfg)
    jc = jmodels.init_cache(jcfg, BATCH, n)
    tc = models.init_cache(cfg, BATCH, n, device="cpu")
    jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(0))
    tl, tc = step(tp, tc, torch.from_numpy(tok).long(), 0)
    assert tl.shape == (BATCH, cfg.vocab_size)
    assert _gap(tl, jl) <= BAND
    for t in range(PROMPT, n):
        nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
        pos = t if t == PROMPT else torch.tensor(t)
        jl, jc = jstep(jp, jc, jnp.asarray(nxt), jnp.int32(t))
        tl, tc = step(tp, tc, torch.from_numpy(nxt).long(), pos)
        assert _gap(tl, jl) <= BAND, t


def _long_setup(arch):
    kw = GEOMETRY.get(arch, {})
    if arch == "granite-moe-3b-a800m":
        kw = dict(d_model=384, n_heads=6)
    cfg, jcfg, jp, tp = _setup(arch, **kw)
    return (replace(cfg, attn_window_override=WINDOW),
            replace(jcfg, attn_window_override=WINDOW), jp, tp)


@pytest.mark.parametrize("arch", WINDOW_ARCHS)
def test_windowed_decode_matches_reference(arch):
    """``make_decode_step(cfg, shape)`` at a long_500k-named shape (window
    16 over 64 positions) against the reference's: 40 tokens (a chunk, or
    one at a time for the encoder-decoder, whose step takes one), then
    one-token steps past the window; the same steps without the shape
    attend to every key and give other logits."""
    cfg, jcfg, jp, tp = _long_setup(arch)
    shape, jshape = InputShape(**LONG), JInputShape(**LONG)
    assert specs.effective_window(cfg, shape) == WINDOW
    tok = _tokens(cfg, (BATCH, 44), seed=4)
    jstep = jax.jit(jmake_decode_step(jcfg, jshape))
    step, free = make_decode_step(cfg, shape), make_decode_step(cfg)
    jc = jmodels.init_cache(jcfg, BATCH, LONG["seq_len"])
    tc = models.init_cache(cfg, BATCH, LONG["seq_len"], device="cpu")
    fc = models.init_cache(cfg, BATCH, LONG["seq_len"], device="cpu")
    if cfg.encoder_layers:
        frames = np.random.default_rng(5).normal(
            size=(BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        jc["enc_out"] = jax.jit(lambda p, f: jencdec.encode(
            p, jcfg, f))(jp, jnp.asarray(frames))
        with torch.no_grad():
            tc["enc_out"] = encdec.encode(tp, cfg, torch.from_numpy(frames))
        fc["enc_out"] = tc["enc_out"].clone()
        chunks = [(t, t + 1) for t in range(44)]
    else:
        chunks = [(0, 40)] + [(t, t + 1) for t in range(40, 44)]
    for a, b in chunks:
        jl, jc = jstep(jp, jc, jnp.asarray(tok[:, a:b]), jnp.int32(a))
        tl, tc = step(tp, tc, torch.from_numpy(tok[:, a:b]).long(), a)
        fl, fc = free(tp, fc, torch.from_numpy(tok[:, a:b]).long(), a)
        assert _gap(tl, jl) <= BAND, (a, b)
    # past the window the override changes the logits
    assert _gap(fl, jl) > 100 * BAND
