"""The encoder-decoder family (``models/encdec.py``,
``seamless-m4t-large-v2``) on every path of the port against the JAX
package's, on the CPU.

Reduced f32 seamless (``reduced``: 2 encoder and 2 decoder layers, 4 / 4
heads of 64, ``encoder_seq`` 64, vocab 512) with the reference's
``init_params`` carried over by ``convert.encdec_params_from_numpy``, and
the same numpy frames (N(0, 1)) and tokens in both packages.

``BAND`` 1e-4 on logits (magnitude about 4), encoder outputs, losses,
params after a train step and cache leaves: both packages run the same
f32 math with other matmul and reduction orders.  Measured: encoder
output 2.6e-6, forward logits 4.8e-6, decode steps 4.8e-6 (3.0e-6 from
the teacher-forced forward), far inside the band; the reference's own
stepped decode and forward differ by a few 1e-6 on these inputs too.  A
planted fault (the encoder's attention made causal) lands far outside
it.  Greedy tokens of ``generate`` equal the reference's exactly.

On the card ``chip_smoke.py`` phase 24 runs the family at full width
(B4 in the encoder, the decoder and the cross-attention, B5 in the
decode steps) and holds the reduced model on the card to this CPU port.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import encdec as jencdec
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch import models
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.convert import encdec_params_from_numpy, opt_state_from_numpy
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.examples import serve_decode
from repro_torch.launch import serve
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import attention, encdec
from repro_torch.optim import sgd_momentum

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
BAND = 1e-4
BATCH, S_DEC = 2, 12
_CACHE = {}


def _setup(**kw):
    """(port cfg, JAX cfg, JAX params, port params), cached per ``kw``
    (the arguments of ``reduced``)."""
    key = tuple(sorted(kw.items()))
    if key not in _CACHE:
        jcfg = jreduced(jget_config(ARCH), **kw)
        cfg = reduced(get_config(ARCH), **kw)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tp = encdec_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      cfg, "cpu")
        _CACHE[key] = (cfg, jcfg, jp, tp)
    return _CACHE[key]


def _inputs(cfg, s=S_DEC, seed=1):
    """Numpy (tokens (B, s) int32, frames (B, encoder_seq, D) f32)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)
    frames = rng.normal(size=(BATCH, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    return tok, frames


def _t(a):
    a = torch.from_numpy(np.asarray(a))
    return a.long() if a.dtype == torch.int32 else a


def _gap(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _tree_gap(got, want):
    gl, _ = tree_flatten(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    return max(_gap(g, w) for g, w in zip(gl, wl))


# ------------------------------------------------------------- the registry
def test_seamless_is_registered_with_the_reference_config():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert ARCH in ARCH_IDS
    # the port's ids are the reference's, in its order
    assert ARCH_IDS == tuple(JARCH_IDS)
    for f in ("n_layers", "encoder_layers", "encoder_seq", "d_model",
              "n_heads", "n_kv_heads", "d_ff", "vocab_size", "head_dim",
              "arch_type", "long_context_mode", "source", "param_dtype",
              "compute_dtype", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count() == 2_034_782_208
    r, jr = reduced(cfg), jreduced(jcfg)
    assert (r.encoder_layers, r.n_layers, r.n_heads, r.n_kv_heads,
            r.head_dim, r.encoder_seq) == (2, 2, 4, 4, 64, 64)
    for f in ("encoder_layers", "n_layers", "encoder_seq", "d_model",
              "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size"):
        assert getattr(r, f) == getattr(jr, f), f


def _refusal(run, *argv):
    with pytest.raises(SystemExit) as exc:
        run(["--arch", ARCH, *argv])
    return str(exc.value)


def test_serve_cli_refuses_encoder_decoders_as_the_reference():
    """Both CLIs refuse an encoder-decoder and send its user elsewhere:
    the reference to ``examples/serve_encdec.py``, which neither package
    has (ROADMAP C20), the port to its serving example, which runs the
    encoder-decoder's decode."""
    want = _refusal(jserve.run)
    got = _refusal(serve.run, "--device", "cpu")
    assert want.startswith("use ") and want.endswith(" for enc-dec archs")
    assert got == ("use python -m repro_torch.examples.serve_decode for "
                   "enc-dec archs")


def test_serve_cli_refusal_names_an_importable_module():
    import importlib
    msg = _refusal(serve.run, "--device", "cpu")
    name = msg.split("python -m ", 1)[1].split()[0]
    mod = importlib.import_module(name)
    assert callable(mod.main) and "encoder-decoder" in mod.__doc__


# ---------------------------------------------------------------- init tree
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference(dtype):
    """Key paths, shapes and dtypes of ``init_params`` (and of
    ``init_cache``) equal the reference's."""
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget_config(ARCH))
    cfg = replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    jcfg = replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
    for got, want in (
            (models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu"),
             jax.eval_shape(lambda: jmodels.init_params(
                 jcfg, jax.random.PRNGKey(0)))),
            (models.init_cache(cfg, BATCH, 16, device="cpu"),
             jax.eval_shape(lambda: jmodels.init_cache(jcfg, BATCH, 16)))):
        gl, _ = tree_flatten(got)
        wl, _ = jax.tree_util.tree_flatten_with_path(want)
        assert [jax.tree_util.keystr(p) for p, _ in wl] == _keystrs(got)
        for g, (_, w) in zip(gl, wl):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert tp["enc"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    assert tp["dec"]["xattn"]["wo"].shape[0] == cfg.n_layers
    assert float(tp["embed"].float().std()) == pytest.approx(0.02, rel=0.05)


def _keystrs(tree, prefix=""):
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in _keystrs(tree[k], f"{prefix}['{k}']")]
    return [prefix]


def test_convert_checks_the_stacked_layers():
    cfg, jcfg, jp, _ = _setup()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="enc/attn"):
        encdec_params_from_numpy(tree, replace(cfg, encoder_layers=3), "cpu")
    with pytest.raises(ValueError, match="enc/mlp"):
        encdec_params_from_numpy(tree, replace(cfg, d_ff=cfg.d_ff + 1),
                                 "cpu")
    bad = dict(tree, dec={k: v for k, v in tree["dec"].items()
                          if k != "xattn"})
    with pytest.raises(ValueError, match="dec holds"):
        encdec_params_from_numpy(bad, cfg, "cpu")


# ----------------------------------------------------------------- forward
def test_encode_matches_reference():
    cfg, jcfg, jp, tp = _setup()
    _, frames = _inputs(cfg)
    want = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, frames)
    got = encdec.encode(tp, cfg, _t(frames))
    assert got.shape == (BATCH, cfg.encoder_seq, cfg.d_model)
    assert _gap(got, want) <= BAND


@pytest.mark.parametrize("last_only", [False, True], ids=["full", "last"])
def test_forward_matches_reference(last_only):
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    want = jax.jit(lambda p, t, f: jmodels.forward(
        p, jcfg, t, f, last_only=last_only))(jp, tok, frames)
    got = models.forward(tp, cfg, _t(tok), _t(frames), last_only=last_only)
    assert got.shape == (BATCH, 1 if last_only else S_DEC, cfg.vocab_size)
    assert _gap(got, want) <= BAND
    hidden = models.forward(tp, cfg, _t(tok), _t(frames),
                            last_only=last_only, return_hidden=True)
    assert hidden.shape == got.shape[:2] + (cfg.d_model,)


def test_planted_causal_encoder_lands_outside_the_band(monkeypatch):
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    want = jax.jit(lambda p, t, f: jmodels.forward(p, jcfg, t, f))(
        jp, tok, frames)
    real = encdec.chunked_attention
    monkeypatch.setattr(encdec, "chunked_attention",
                        lambda q, k, v, **kw: real(q, k, v,
                                                   **{**kw, "causal": True}))
    assert _gap(models.forward(tp, cfg, _t(tok), _t(frames)), want) > 100 * BAND


def test_prefill_step_takes_frames_as_the_reference():
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    want = jax.jit(jmake_prefill_step(jcfg))(jp, tok, frames)
    got = make_prefill_step(cfg)(tp, _t(tok), _t(frames))
    assert got.shape == (BATCH, cfg.vocab_size) and not got.requires_grad
    assert _gap(got, want) <= BAND


# -------------------------------------------------------------- loss, train
def _batch(cfg, seed=2, weight=None):
    tok, frames = _inputs(cfg, s=S_DEC + 1, seed=seed)
    jb = {"tokens": tok[:, :-1], "labels": tok[:, 1:], "frames": frames}
    if weight is not None:
        jb["weight"] = np.asarray(weight, np.float32)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: _t(v) for k, v in jb.items()})


@pytest.mark.parametrize("vocab", [512, 65536], ids=["ce", "chunked-ce"])
def test_loss_matches_reference(vocab):
    """The weighted loss and per-example losses; a vocabulary of 65536
    takes the chunked CE in both packages."""
    cfg, jcfg, jp, tp = _setup(vocab=vocab)
    jb, tb = _batch(cfg, weight=[1.0, 0.5])
    jl, jm = jax.jit(lambda p, b: jmodels.loss_fn(p, jcfg, b))(jp, jb)
    loss, met = models.loss_fn(tp, cfg, tb)
    assert abs(float(loss) - float(jl)) <= BAND
    assert _gap(met["per_example"], jm["per_example"]) <= BAND


def test_loss_runs_the_training_scans(monkeypatch):
    """Every attention of the training forward (encoder, decoder,
    cross-attention) asks ``chunked_attention`` for the differentiable
    scan: on the card B4 has no backward."""
    cfg, _, _, tp = _setup()
    _, tb = _batch(cfg)
    seen = []
    real = attention.chunked_attention

    def rec(q, k, v, **kw):
        seen.append((kw.get("causal", True), kw.get("train", False)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(attention, "chunked_attention", rec)
    monkeypatch.setattr(encdec, "chunked_attention", rec)
    models.loss_fn(tp, cfg, tb)
    assert sorted(seen) == sorted(
        [(False, True)] * (cfg.encoder_layers + cfg.n_layers)
        + [(True, True)] * cfg.n_layers)
    seen.clear()
    models.forward(tp, cfg, tb["tokens"], tb["frames"])
    assert {t for _, t in seen} == {False} and len(seen) == 6


def test_train_step_matches_reference():
    """One ``make_train_step`` step with ``sgd_momentum(0.9)``: the loss,
    the params and the momentum."""
    cfg, jcfg, jp, tp = _setup()
    jb, tb = _batch(cfg, seed=3)
    jo, to = jsgd_momentum(0.9), sgd_momentum(0.9)
    js0 = jo.init(jp)
    ts0 = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js0),
                               "cpu")
    jp1, js1, jloss = jax.jit(jmake_train_step(jcfg, jo))(jp, js0, jb, 0.05)
    tp1, ts1, loss = make_train_step(cfg, to)(tp, ts0, tb, 0.05)
    assert abs(float(loss) - float(jloss)) <= BAND
    assert _tree_gap(tp1, jp1) <= BAND
    assert _tree_gap(ts1, js1) <= BAND
    assert _tree_gap(tp1, jp) > 0                      # the params moved


# ------------------------------------------------------------------ decode
def _decode_pair(cfg, jcfg, jp, tp, frames):
    """Both packages' caches with the encoder output set."""
    jc = jmodels.init_cache(jcfg, BATCH, S_DEC)
    jc["enc_out"] = jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(
        jp, frames)
    tc = models.init_cache(cfg, BATCH, S_DEC, device="cpu")
    with torch.no_grad():
        tc["enc_out"] = encdec.encode(tp, cfg, _t(frames))
    return jc, tc


@pytest.mark.parametrize("pos_kind", ["host", "device"])
def test_decode_steps_match_reference_and_forward(pos_kind):
    """One-token steps over the decoder tokens: each step's logits and the
    caches within BAND of the reference's jitted step, and the logits
    within BAND of the teacher-forced forward (the reference's
    ``test_models_smoke.py`` check); a device ``pos`` (a 0-d int32
    tensor) gives the host int's bits."""
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    jc, tc = _decode_pair(cfg, jcfg, jp, tp, frames)
    jdec = jax.jit(lambda p, c, t, pos: jmodels.decode_step(p, jcfg, c, t,
                                                            pos))
    full = models.forward(tp, cfg, _t(tok), _t(frames))
    host = models.init_cache(cfg, BATCH, S_DEC, device="cpu")
    host["enc_out"] = tc["enc_out"].clone()
    for s in range(S_DEC):
        jl, jc = jdec(jp, jc, tok[:, s:s + 1], jnp.int32(s))
        pos = s if pos_kind == "host" else torch.tensor(s,
                                                        dtype=torch.int32)
        tl, tc2 = models.decode_step(tp, cfg, tc, _t(tok[:, s:s + 1]), pos,
                                     window=0)
        assert tc2 is tc                                  # in place
        assert _gap(tl, jl) <= BAND
        assert _gap(tl[:, 0], full[:, s].detach()) <= BAND
        if pos_kind == "device":
            hl, _ = models.decode_step(tp, cfg, host, _t(tok[:, s:s + 1]), s)
            assert torch.equal(hl, tl)
    assert _tree_gap(tc, jc) <= BAND
    assert torch.equal(tc["enc_out"], host["enc_out"])


def test_a_chunk_is_refused_as_the_reference_fails_it():
    """The reference's step takes one token: its RoPE positions are
    ``jnp.full((b, 1), pos)`` and it reshapes the self-attention output to
    (B, 1, ·), which a chunk (T > 1) cannot take.  The port refuses the
    chunk before it touches the cache."""
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    jc, tc = _decode_pair(cfg, jcfg, jp, tp, frames)
    with pytest.raises(TypeError, match=r"\(2, 1, 256\)"):
        jmodels.decode_step(jp, jcfg, jc, tok[:, :5], jnp.int32(0))
    with pytest.raises(ValueError, match="takes one token"):
        models.decode_step(tp, cfg, tc, _t(tok[:, :5]), 0)
    assert float(tc["k"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="does not fit"):
        models.decode_step(tp, cfg, tc, _t(tok[:, :1]), S_DEC)


def test_make_decode_step_matches_reference():
    cfg, jcfg, jp, tp = _setup()
    tok, frames = _inputs(cfg)
    jc, tc = _decode_pair(cfg, jcfg, jp, tp, frames)
    jl, _ = jax.jit(jmake_decode_step(jcfg))(jp, jc, tok[:, :1],
                                              jnp.int32(0))
    tl, _ = make_decode_step(cfg)(tp, tc, _t(tok[:, :1]),
                                  torch.tensor(0, dtype=torch.int32))
    assert tl.shape == (BATCH, cfg.vocab_size)
    assert _gap(tl, jl) <= BAND


def test_generate_matches_reference():
    """The static ``generate``: this family steps its prompt token by
    token over the zero ``enc_out`` of a fresh cache, as the reference's;
    the greedy tokens are the reference's exactly."""
    cfg, jcfg, jp, tp = _setup()
    tok, _ = _inputs(cfg, s=6)
    assert not serve.chunkable(cfg)
    want = np.asarray(jserve.generate(jcfg, jp, jnp.asarray(tok), gen=6,
                                      max_seq=12))
    got, logits = serve.generate(cfg, tp, _t(tok), gen=6, max_seq=12,
                                 return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want[:, 6:])


def test_serve_decode_example_runs_the_encoder_decoder():
    """The example's encoder-decoder part on the CPU: 24 greedy one-token
    steps at a device position from the encoder output of seeded frames,
    the same tokens as host-int steps through ``models.decode_step``."""
    out = serve_decode.main(["--device", "cpu"])
    toks = out[ARCH]
    cfg = reduced(get_config(ARCH))
    assert toks.shape == (2, 24) and int(toks.min()) >= 0 and \
        int(toks.max()) < cfg.vocab_size
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                         generator=torch.Generator().manual_seed(0))
    cache = models.init_cache(cfg, 2, 24, device="cpu")
    cache["enc_out"] = encdec.encode(params, cfg, frames).detach()
    tok, want = torch.zeros((2, 1), dtype=torch.long), []
    for t in range(24):
        logits, cache = models.decode_step(params, cfg, cache, tok, t)
        tok = logits[:, -1].argmax(-1)[:, None]
        want.append(tok)
    assert torch.equal(toks, torch.cat(want, dim=1))


def test_refusals_that_stay():
    cfg = reduced(get_config(ARCH))
    from repro_torch.configs.base import InputShape
    from repro_torch.models.layers import MetaDraws
    # an input shape's window reaches the self-attention (0 at decode_32k)
    tp = encdec.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    outs = [make_decode_step(cfg, shape)(
        tp, encdec.init_cache(cfg, 1, 4, device="cpu"), tok, 0)[0]
        for shape in (None, InputShape("decode_32k", 32768, 1, "decode"))]
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encdec.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError, match="draw them where they live"):
        encdec.init_params(cfg, torch.Generator(), device="meta")
    with pytest.raises(ValueError, match="draw them where they live"):
        encdec.init_params(cfg, MetaDraws(), device="cpu")
    tc = encdec.init_cache(cfg, 1, 4, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        "k": (2, 1, 4, 4, 64), "v": (2, 1, 4, 4, 64),
        "enc_out": (1, 64, 256)}
    assert all(float(t.abs().sum()) == 0.0 for t in tree_leaves(tc))
