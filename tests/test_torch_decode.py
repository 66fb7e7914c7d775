"""The port's decode path with a cache (``models.init_cache`` /
``decode_step``, ``launch.steps.make_decode_step``, the static
``launch.serve.generate``) against the JAX package's, on the CPU.

Reduced f32 configs, each with the reference's ``init_params`` carried
over through ``convert.lm_params_from_numpy`` and the same numpy tokens:
``phi3-mini-3.8b``, ``gemma3-4b`` (window 16, smaller than the prompt of
20 plus the 6 generated tokens, so that the window masks keys; at 2 layers
both local, at 6 five local and then the global layer, ``i % 6 == 5``),
``zamba2-2.7b`` at 6 layers (so that its weight-tied shared block runs)
and ``rwkv6-7b``; 2 prompts of ``PROMPT`` tokens, ``max_seq`` = PROMPT +
GEN.

``BAND`` 1e-4 on the logits (magnitude about 4) and on every cache leaf:
the two packages run the same f32 math with other matmul and reduction
orders.  Measured on the stepped prompt: logits 5.2e-6 (phi3), 3.8e-6
(gemma3), 6.8e-6 (zamba2) and 6.2e-5 (rwkv6, at its second step; 1.1e-5
from the fourth on), caches at most 1.5e-5 (rwkv6's WKV states reach
14.6); the chunks 6.1e-6.  rwkv6's early steps are ill-conditioned, not
apart: on these tokens the reference's own prefill forward and stepped
decode differ by 1.7e-5, and the two packages' prefill forwards by
7.8e-5.  The module functions (``decode_attention``,
``decode_attention_dyn``, the SSD and WKV steps) are held within
``FN_ATOL`` 2e-5 (measured at most 2.4e-6).  Three planted faults — the
sliding window one key too wide (gap 1.28), gemma3's global layer given
the local window (0.30, where the free 6-layer run lies 5.1e-6 off), the
WKV bonus ``u`` dropped in the step (4.75) — land far outside the band.

The kernels' plain forms on this path: B5 (``flash_decode``) on the
strided ``(B, S, KV, hd)`` layer cache and at hd 80, against the
reference's oracle ``ref.flash_decode_ref`` and its Pallas kernel in
interpret mode (measured 3.6e-7 from both in f32); B4
(``flash_attention``) with a query offset against the reference's
``decode_attention_dyn`` (the Pallas B4 has no offset; measured 2.4e-7).
On
the card ``chip_smoke.py`` phase 21 holds the kernels against these plain
forms and runs the path at full width.

A device ``pos`` (a 0-d integer tensor, the reference's traced
``jnp.int32(pos)``) through ``decode_step``, ``make_decode_step`` and the
B4 / B5 wrappers gives the host int's logits and caches bit for bit (and
stays within BAND of the reference's jitted step), for one token and for
chunks of 2, 17 and 64 — at a ``pos`` whose chunk the reference's
``dynamic_update_slice`` clamps too: the same rows written, RoPE and the
mask at the unclamped ``pos``; ``generate`` prefills and steps on one such
tensor; a tensor ``pos`` of another dtype, shape or device is refused.
B4's plain form reads the cache through its ``transpose(1, 2)`` view.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import flash_decode as jfd
from repro.kernels import ref as jref
from repro.launch.serve import chunkable as jchunkable
from repro.launch.serve import generate as jgenerate
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import attention as jattention
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtransformer
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (cache_from_numpy, cache_to_numpy,
                                 lm_params_from_numpy, tensor_from_numpy)
from repro_torch.core.tree import tree_flatten
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention, mamba2, rwkv6, transformer

torch.set_num_threads(1)

BAND = 1e-4
FN_ATOL = 2e-5
PROMPT, GEN, BATCH = 20, 6, 2
MAX_SEQ = PROMPT + GEN
ARCHS = [("phi3-mini-3.8b", 2), ("gemma3-4b", 2), ("gemma3-4b", 6),
         ("zamba2-2.7b", 6), ("rwkv6-7b", 2)]
ATTN_ARCHS = ARCHS[:3]
_CACHE = {}


def _setup(arch, layers):
    """(port cfg, JAX cfg, JAX params, port params, prompts)."""
    key = (arch, layers)
    if key not in _CACHE:
        jcfg = jreduced(jget_config(arch), layers=layers)
        cfg = reduced(get_config(arch), layers=layers)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")
        tok = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
        _CACHE[key] = (cfg, jcfg, jp, tp, tok)
    return _CACHE[key]


def _jdecode(jcfg):
    """The reference's decode step, jitted once per config: full (B, T, V)
    logits and the new cache."""
    key = ("jdecode", jcfg.name, jcfg.n_layers)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(lambda p, c, t, pos: jmodels.decode_step(
            p, jcfg, c, t, pos))
    return _CACHE[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _gap(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _cache_gap(port_cache, jcache):
    got, want = cache_to_numpy(port_cache), _np(jcache)
    gl, gd = tree_flatten(got)
    wl, wd = tree_flatten(want)
    assert gd == wd
    return max(_gap(a, b) for a, b in zip(gl, wl))


def _stepped(arch, layers):
    """Both packages stepping the prompt one token at a time: per-step
    logits (B, PROMPT, V) and the final caches."""
    key = ("stepped", arch, layers)
    if key not in _CACHE:
        cfg, jcfg, jp, tp, tok = _setup(arch, layers)
        jc = jmodels.init_cache(jcfg, BATCH, MAX_SEQ)
        tc = models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
        jl, tl = [], []
        for t in range(PROMPT):
            lg, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                    jnp.int32(t))
            jl.append(np.asarray(lg))
            lt, tc = models.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t:t + 1]).long(), t)
            tl.append(lt.numpy())
        _CACHE[key] = (np.concatenate(tl, 1), np.concatenate(jl, 1), tc, jc)
    return _CACHE[key]


def _jgenerate(arch, layers, stepped):
    key = ("jgen", arch, layers, stepped)
    if key not in _CACHE:
        _, jcfg, jp, _, tok = _setup(arch, layers)
        _CACHE[key] = np.asarray(jgenerate(
            jcfg, jp, jnp.asarray(tok), gen=GEN, max_seq=MAX_SEQ,
            stepped_prefill=stepped))
    return _CACHE[key]


# ----------------------------- cache trees ----------------------------------
@pytest.mark.parametrize("arch,layers", ARCHS)
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_init_cache_matches_reference(arch, layers, width):
    """Segments, keys, shapes and dtypes of the cache tree equal the
    reference's (full width on the meta device against ``eval_shape``)."""
    if width == "full":
        cfg, jcfg = get_config(arch), jget_config(arch)
        want = jax.eval_shape(lambda: jmodels.init_cache(jcfg, 3, 7))
        got = models.init_cache(cfg, 3, 7, device="meta")
    else:
        cfg, jcfg, _, _, _ = _setup(arch, layers)
        want = jmodels.init_cache(jcfg, 3, 7)
        got = models.init_cache(cfg, 3, 7, device="cpu")
    gl, gd = tree_flatten(got)
    wl, wd = tree_flatten(list(want))
    assert gd == wd
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype)[6:] == str(w.dtype)
        if width == "reduced":
            assert not g.any()


def test_init_cache_defaults_to_the_card_and_refuses_cnns():
    cfg = reduced(get_config("phi3-mini-3.8b"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.init_cache(cfg, 1, 4)
    with pytest.raises(ValueError, match="CNNs"):
        models.init_cache(get_config("cifar-resnet18"), 1, 4, device="cpu")


# --------------------------- module functions --------------------------------
def _attn_inputs(seed, *, b=2, t=1, h=4, kv=2, hd=16, s=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("pos,window", [(0, 0), (13, 0), (13, 8), (23, 5)])
def test_decode_attention_matches_reference(pos, window):
    q, k, v = _attn_inputs(pos + window)
    want = jattention.decode_attention(*map(jnp.asarray, (q, k, v)), pos,
                                       window=window)
    got = attention.decode_attention(*map(torch.from_numpy, (q, k, v)), pos,
                                     window=window)
    assert got.shape == want.shape
    assert _gap(got, want) <= FN_ATOL


@pytest.mark.parametrize("t,pos,window", [(1, 9, 0), (1, 9, 4), (5, 7, 0),
                                          (5, 7, 4), (5, 0, 3)])
def test_decode_attention_dyn_matches_reference(t, pos, window):
    q, k, v = _attn_inputs(10 * t + pos, t=t)
    want = jtransformer.decode_attention_dyn(*map(jnp.asarray, (q, k, v)),
                                             jnp.int32(pos), window)
    got = transformer.decode_attention_dyn(*map(torch.from_numpy, (q, k, v)),
                                           pos, window)
    assert got.shape == want.shape
    assert _gap(got, want) <= FN_ATOL


def test_ssd_decode_step_and_mamba2_decode_match_reference():
    rng = np.random.default_rng(2)
    bt, h, p, n = 2, 3, 8, 5
    hs = rng.standard_normal((bt, h, p, n)).astype(np.float32)
    x = rng.standard_normal((bt, h, p)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((bt, h))).astype(np.float32)
    a_log = np.log(np.linspace(1, 8, h)).astype(np.float32)
    B, C = (rng.standard_normal((bt, n)).astype(np.float32) for _ in "BC")
    d = np.ones(h, np.float32)
    args = (hs, x, dt, a_log, B, C, d)
    jy, jh = jmamba2.ssd_decode_step(*map(jnp.asarray, args))
    y, hn = mamba2.ssd_decode_step(*map(torch.from_numpy, args))
    assert _gap(y, jy) <= FN_ATOL and _gap(hn, jh) <= FN_ATOL

    cfg, jcfg, jp, tp, _ = _setup("zamba2-2.7b", 6)
    sc = cfg.ssm
    d_in = sc.expand * cfg.d_model
    state = {"h": rng.standard_normal(
        (bt, d_in // sc.head_dim, sc.head_dim, sc.d_state)).astype(np.float32),
        "conv": rng.standard_normal(
            (bt, sc.d_conv - 1, d_in + 2 * sc.d_state)).astype(np.float32)}
    xin = rng.standard_normal((bt, 1, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["segments"][0])
    tlayer = jax.tree_util.tree_map(lambda a: a[0], tp["segments"][0])
    jy, jst = jmamba2.mamba2_decode(jlayer["mamba"], jnp.asarray(xin), jcfg,
                                    jax.tree_util.tree_map(jnp.asarray,
                                                           state))
    y, st = mamba2.mamba2_decode(
        tlayer["mamba"], torch.from_numpy(xin), cfg,
        {k: torch.from_numpy(a) for k, a in state.items()})
    assert _gap(y, jy) <= FN_ATOL
    assert _gap(st["h"], jst["h"]) <= FN_ATOL
    assert _gap(st["conv"], jst["conv"]) <= FN_ATOL


def test_wkv6_step_time_mix_and_channel_mix_match_reference():
    rng = np.random.default_rng(3)
    b, h, kd = 2, 3, 8
    S = rng.standard_normal((b, h, kd, kd)).astype(np.float32)
    r, k, v = (rng.standard_normal((b, h, kd)).astype(np.float32)
               for _ in range(3))
    w = rng.random((b, h, kd)).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32)
    jy, jS = jrwkv6.wkv6_step(*map(jnp.asarray, (S, r, k, v, w, u)))
    y, S2 = rwkv6.wkv6_step(*map(torch.from_numpy, (S, r, k, v, w, u)))
    assert y.dtype == torch.float32
    assert _gap(y, jy) <= FN_ATOL and _gap(S2, jS) <= FN_ATOL

    cfg, jcfg, jp, tp, _ = _setup("rwkv6-7b", 2)
    jlayer = jax.tree_util.tree_map(lambda a: a[1], jp["segments"][0])
    tlayer = jax.tree_util.tree_map(lambda a: a[1], tp["segments"][0])
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    sh_t, sh_c = (rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
                  for _ in range(2))
    wkv = rng.standard_normal((b, cfg.n_heads, cfg.head_dim, cfg.head_dim)) \
        .astype(np.float32)
    jo, jlast, jwkv = jrwkv6.time_mix(
        jlayer["rwkv"], jnp.asarray(x), jcfg, shift_state=jnp.asarray(sh_t),
        wkv_state=jnp.asarray(wkv), decode=True)
    o, last, wkv2 = rwkv6.time_mix(
        tlayer["rwkv"], torch.from_numpy(x), cfg,
        shift_state=torch.from_numpy(sh_t), wkv_state=torch.from_numpy(wkv),
        decode=True)
    assert _gap(o, jo) <= FN_ATOL and _gap(wkv2, jwkv) <= FN_ATOL
    assert _gap(last, jlast) == 0.0
    jc, jcl = jrwkv6.channel_mix(jlayer["rwkv"], jnp.asarray(x), jcfg,
                                 shift_state=jnp.asarray(sh_c))
    c, cl = rwkv6.channel_mix(tlayer["rwkv"], torch.from_numpy(x), cfg,
                              shift_state=torch.from_numpy(sh_c))
    assert _gap(c, jc) <= FN_ATOL and _gap(cl, jcl) == 0.0


# ------------------------------- decode_step ---------------------------------
@pytest.mark.parametrize("arch,layers", ARCHS)
def test_decode_step_one_token_matches_reference(arch, layers):
    """T = 1 steps over the whole prompt: every step's logits and the final
    caches within BAND; on the CPU no kernel wrapper runs."""
    fd.reset_counts()
    fa.reset_counts()
    got, want, tc, jc = _stepped(arch, layers)
    assert got.shape == want.shape == (BATCH, PROMPT,
                                       _setup(arch, layers)[0].vocab_size)
    assert _gap(got, want) <= BAND
    assert _cache_gap(tc, jc) <= BAND
    assert fd.launch_count() + fd.plain_count() == 0
    assert fa.launch_count() + fa.plain_count() == 0


@pytest.mark.parametrize("arch,layers", ATTN_ARCHS)
def test_decode_step_chunks_match_reference(arch, layers):
    """A chunk of PROMPT - 5 tokens at 0, then one of 5 at PROMPT - 5: the
    logits of both chunks and the caches within BAND, and the same cache
    as stepping the prompt token by token."""
    cfg, jcfg, jp, tp, tok = _setup(arch, layers)
    cut = PROMPT - 5
    jc = jmodels.init_cache(jcfg, BATCH, MAX_SEQ)
    tc = models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    for lo, hi in ((0, cut), (cut, PROMPT)):
        jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(tok[:, lo:hi]),
                                jnp.int32(lo))
        tl, tc2 = models.decode_step(tp, cfg, tc,
                                     torch.from_numpy(tok[:, lo:hi]).long(),
                                     lo)
        assert tc2 is tc                          # updated in place
        assert tl.shape == (BATCH, hi - lo, cfg.vocab_size)
        assert _gap(tl, jl) <= BAND
    assert _cache_gap(tc, jc) <= BAND
    assert _cache_gap(tc, _stepped(arch, layers)[3]) <= BAND


@pytest.mark.parametrize("arch,layers", ARCHS[3:])
def test_recurrent_decode_refuses_chunks(arch, layers):
    cfg, _, _, tp, tok = _setup(arch, layers)
    cache = models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="steps one token"):
        models.decode_step(tp, cfg, cache, torch.from_numpy(tok[:, :3]), 0)


def test_decode_step_continues_a_reference_cache():
    """A cache the reference filled (3 steps), carried over with
    ``cache_from_numpy``, decodes the next token as the reference does."""
    cfg, jcfg, jp, tp, tok = _setup("zamba2-2.7b", 6)
    jc = jmodels.init_cache(jcfg, BATCH, MAX_SEQ)
    for t in range(3):
        _, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                               jnp.int32(t))
    tc = cache_from_numpy(_np(jc), cfg, "cpu")
    jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(tok[:, 3:4]), jnp.int32(3))
    tl, tc = models.decode_step(tp, cfg, tc, torch.from_numpy(tok[:, 3:4]), 3)
    assert _gap(tl, jl) <= BAND and _cache_gap(tc, jc) <= BAND
    with pytest.raises(ValueError, match="segments"):
        cache_from_numpy(_np(jc)[:-1], cfg, "cpu")


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_make_decode_step_matches_reference(arch, layers):
    """The last position's logits (B, V) of a step, as the reference's
    ``make_decode_step`` returns them."""
    cfg, jcfg, jp, tp, tok = _setup(arch, layers)
    t = 1 if arch in ("zamba2-2.7b", "rwkv6-7b") else 4
    jl, _ = jax.jit(jmake_decode_step(jcfg))(
        jp, jmodels.init_cache(jcfg, BATCH, MAX_SEQ), jnp.asarray(tok[:, :t]),
        jnp.int32(0))
    tl, _ = make_decode_step(cfg)(
        tp, models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu"),
        torch.from_numpy(tok[:, :t]).long(), 0)
    assert tl.shape == (BATCH, cfg.vocab_size)
    assert _gap(tl, jl) <= BAND


def test_make_decode_step_refuses_what_waits():
    from dataclasses import replace

    from repro_torch.configs.base import InputShape, MoEConfig
    cfg = reduced(get_config("phi3-mini-3.8b"))
    # an input shape sets the step's window (launch/specs.py, tests/
    # test_torch_configs.py): decode_32k keeps the config's layers, a
    # long_500k-named one makes every global layer a window of
    # attn_window_override keys
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")

    def step(shape, pos, window=8192):
        c = replace(cfg, attn_window_override=window)
        cache = models.init_cache(c, 1, 8, device="cpu")
        for t in range(pos + 1):
            logits, cache = make_decode_step(c, shape)(
                tp, cache, torch.full((1, 1), 3 * t + 1), t)
        return logits
    base = step(None, 5)
    assert torch.equal(
        step(InputShape("decode_32k", 32768, 1, "decode"), 5), base)
    long = InputShape("long_500k", 8, 1, "decode")
    assert torch.equal(step(long, 5, window=8), base)
    assert not torch.equal(step(long, 5, window=2), base)
    # an encoder-decoder's decode is ported (ROADMAP A12d, tests/
    # test_torch_encdec.py): phi3's widths with 2 encoder layers step over
    # the self-attention cache and the encoder output
    enc = replace(cfg, encoder_layers=2, encoder_seq=8)
    ep = models.init_params(enc, torch.Generator().manual_seed(0),
                            device="cpu")
    logits, cache = make_decode_step(enc)(
        ep, models.init_cache(enc, 1, 4, device="cpu"),
        torch.zeros(1, 1, dtype=torch.long), 0)
    assert logits.shape == (1, enc.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert set(cache) == {"k", "v", "enc_out"}
    # an MoE model's decode is ported (ROADMAP A12c, tests/
    # test_torch_moe_paths.py): its cache is the attention k / v
    moe = replace(cfg, moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    cache = models.init_cache(moe, 1, 4, device="cpu")
    assert [set(c) for c in cache] == [{"k", "v"}]


# ----------------------------- a device pos ----------------------------------
def _pos(t):
    return torch.tensor(t, dtype=torch.int32)


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_decode_step_tensor_pos_matches_host_int(arch, layers):
    """T = 1 steps over the prompt with ``pos`` a 0-d int32 tensor (the
    reference's traced ``jnp.int32(t)``): the host int's logits and caches
    bit for bit, and within BAND of the reference's jitted step."""
    cfg, _, _, tp, tok = _setup(arch, layers)
    want, jwant, tc_int, jc = _stepped(arch, layers)
    tc = models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    got = []
    for t in range(PROMPT):
        lt, tc = models.decode_step(
            tp, cfg, tc, torch.from_numpy(tok[:, t:t + 1]).long(), _pos(t))
        got.append(lt.numpy())
    got = np.concatenate(got, 1)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tree_flatten(tc)[0], tree_flatten(tc_int)[0]):
        assert torch.equal(a, b)
    assert _gap(got, jwant) <= BAND and _cache_gap(tc, jc) <= BAND


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_make_decode_step_tensor_pos_matches_host_int(arch, layers):
    """``make_decode_step`` one token after a stepped prompt of 3, at an
    int64 0-d tensor ``pos``: the host int's logits bit for bit, within
    BAND of the reference's step jitted with ``jnp.int32(3)``."""
    cfg, jcfg, jp, tp, tok = _setup(arch, layers)
    jc = jmodels.init_cache(jcfg, BATCH, MAX_SEQ)
    jstep = jax.jit(jmake_decode_step(jcfg))
    step = make_decode_step(cfg)
    caches = [models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
              for _ in range(2)]
    for t in range(4):
        x = tok[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(x), jnp.int32(t))
        li, caches[0] = step(tp, caches[0], torch.from_numpy(x).long(), t)
        lt, caches[1] = step(tp, caches[1], torch.from_numpy(x).long(),
                             torch.tensor(t))
    assert torch.equal(lt, li)
    assert _gap(lt, jl) <= BAND


def test_tensor_pos_refusals():
    """A tensor ``pos`` must be a 0-d integer on the tokens' device (a
    chunk of any length takes one, with the host int's bits); B4's and
    B5's wrappers take a 0-d int32 on q's device and refuse anything else;
    on the CPU a tensor pos gives their plain forms the host int's bits."""
    cfg, _, _, tp, tok = _setup("phi3-mini-3.8b", 2)
    one, chunk = (torch.from_numpy(tok[:, :n]).long() for n in (1, 3))
    caches = [models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
              for _ in range(2)]
    li, _ = models.decode_step(tp, cfg, caches[0], chunk, 4)
    lt, _ = models.decode_step(tp, cfg, caches[1], chunk, _pos(4))
    assert torch.equal(lt, li)
    for a, b in zip(tree_flatten(caches[0])[0], tree_flatten(caches[1])[0]):
        assert torch.equal(a, b)
    for bad in (torch.tensor(2.0), torch.tensor([2]), _pos(2).to("meta"),
                torch.tensor(True)):
        with pytest.raises(ValueError, match="0-d integer"):
            models.decode_step(tp, cfg, caches[0], one, bad)
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(7, t=3))
    tq, tk, tv = q.transpose(1, 2).contiguous(), k.transpose(1, 2), \
        v.transpose(1, 2)
    for pos, w in ((0, 0), (5, 0), (13, 4)):
        assert torch.equal(
            transformer.decode_attention_dyn(q, k, v, _pos(pos), w),
            transformer.decode_attention_dyn(q, k, v, pos, w))
        assert torch.equal(
            fa.flash_attention(tq, tk, tv, window=w, q_offset=_pos(pos)),
            fa.flash_attention(tq, tk, tv, window=w, q_offset=pos))
    for bad in (torch.tensor(3.0), torch.tensor([3], dtype=torch.int32),
                torch.tensor(3), _pos(3).to("meta")):
        with pytest.raises(ValueError, match="0-d int32"):
            fa.flash_attention(tq, tk, tv, q_offset=bad)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 80)).astype(
        np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 40, 2, 80)).astype(
        np.float32)).transpose(1, 2) for _ in "kv")
    for pos, w in ((0, 0), (23, 0), (39, 8)):
        assert torch.equal(fd.flash_decode(q, kc, vc, _pos(pos), window=w),
                           fd.flash_decode(q, kc, vc, pos, window=w))
    for bad in (torch.tensor(3.0), torch.tensor([3], dtype=torch.int32),
                torch.tensor(3), _pos(3).to("meta")):
        with pytest.raises(ValueError, match="0-d int32"):
            fd.flash_decode(q, kc, vc, bad)


def test_generate_steps_on_a_device_pos(monkeypatch):
    """``generate`` takes every call's position from one int32 tensor on
    the prompts' device, advanced in place: the chunked prefill at 0 (the
    reference's ``jnp.int32(0)``), then each one-token step; the stepped
    prefill steps on it from 0.  No call takes a host int."""
    cfg, _, _, tp, tok = _setup("phi3-mini-3.8b", 2)
    seen = []
    inner = serve.make_decode_step

    def make(cfg_, shape=None):
        step = inner(cfg_, shape)

        def record(params, cache, tokens, pos):
            seen.append((tokens.shape[1], pos if isinstance(pos, int) else
                         (pos.dtype, tuple(pos.shape), int(pos), id(pos))))
            return step(params, cache, tokens, pos)
        return record
    monkeypatch.setattr(serve, "make_decode_step", make)
    for stepped in (False, True):
        seen.clear()
        serve.generate(cfg, tp, torch.from_numpy(tok).long(), gen=3,
                       max_seq=PROMPT + 3, stepped_prefill=stepped)
        assert not [p for _, p in seen if isinstance(p, int)]
        want = (list(range(PROMPT + 2)) if stepped
                else [0, PROMPT, PROMPT + 1])
        assert [p[2] for _, p in seen] == want
        assert [t for t, _ in seen] == ([1] * (PROMPT + 2) if stepped
                                        else [PROMPT, 1, 1])
        assert {p[:2] for _, p in seen} == {(torch.int32, ())}
        assert len({p[3] for _, p in seen}) == 1        # one tensor


# chunks at a device pos: the cache holds CHUNK_SEQ positions filled with
# noise, so that every key the mask keeps carries a value; "inside" puts
# the chunk within the cache, "clamped" past its end, where the reference's
# dynamic_update_slice moves the write back to CHUNK_SEQ - T
CHUNK_SEQ = 80
CHUNK_POS = {2: (40, CHUNK_SEQ - 2 + 5), 17: (40, CHUNK_SEQ - 17 + 6),
             64: (9, CHUNK_SEQ - 64 + 7)}


def _filled_caches(arch, layers, seed):
    """The reference's cache tree of CHUNK_SEQ positions filled with
    numpy noise, and the port's copy of it."""
    cfg, jcfg, _, _, _ = _setup(arch, layers)
    rng = np.random.default_rng(seed)
    fill = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype),
        _np(jmodels.init_cache(jcfg, BATCH, CHUNK_SEQ)))
    return fill, cache_from_numpy(jax.tree_util.tree_map(np.copy, fill),
                                  cfg, "cpu")


def _jstep(jcfg, t):
    key = ("jstep", jcfg.name, jcfg.n_layers, t)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(jmake_decode_step(jcfg))
    return _CACHE[key]


@pytest.mark.parametrize("where", ["inside", "clamped"])
@pytest.mark.parametrize("t", [2, 17, 64])
@pytest.mark.parametrize("arch,layers,window", [("phi3-mini-3.8b", 2, 0),
                                                ("gemma3-4b", 2, 16),
                                                ("gemma3-4b", 6, 16)])
def test_device_pos_chunks_match_reference(arch, layers, window, t, where):
    """A chunk of T tokens at a 0-d int32 ``pos`` through
    ``make_decode_step`` against the reference's jitted step at
    ``jnp.int32(pos)`` (gemma3's local layers with their window of 16):
    logits and caches within BAND; the cache rows written are the
    reference's (``[min(pos, S - T), + T)``, clamped as its
    ``dynamic_update_slice`` clamps) and every other row keeps its bits.
    Inside the cache, the host int gives the same bits; past it, a host
    int is refused (the port's one difference: it cannot clamp a host
    value quietly).  ``decode_step``'s (B, T, V) logits end in the step's."""
    cfg, jcfg, jp, tp, _ = _setup(arch, layers)
    assert max(cfg.attn_window, 0) in (0, window)
    pos = CHUNK_POS[t][where == "clamped"]
    toks = np.random.default_rng(t).integers(
        0, cfg.vocab_size, (BATCH, t)).astype(np.int32)
    fill, tc = _filled_caches(arch, layers, seed=t)
    jl, jc = _jstep(jcfg, t)(jp, jax.tree_util.tree_map(jnp.asarray, fill),
                             jnp.asarray(toks), jnp.int32(pos))
    tl, tc = make_decode_step(cfg)(tp, tc, torch.from_numpy(toks).long(),
                                   _pos(pos))
    assert tl.shape == (BATCH, cfg.vocab_size)
    assert _gap(tl, jl) <= BAND
    assert _cache_gap(tc, jc) <= BAND
    start = min(pos, CHUNK_SEQ - t)
    rows = np.zeros(CHUNK_SEQ, bool)
    rows[start:start + t] = True
    for got, want, before in zip(tree_flatten(cache_to_numpy(tc))[0],
                                 tree_flatten(_np(jc))[0],
                                 tree_flatten(fill)[0]):
        # (layers, B, S, KV, hd): the positions on axis 2
        np.testing.assert_array_equal(got[:, :, ~rows], before[:, :, ~rows])
        assert (got[:, :, rows] != before[:, :, rows]).any(axis=(0, 1, 3, 4)) \
            .all()
        assert (want[:, :, rows] != before[:, :, rows]).any(
            axis=(0, 1, 3, 4)).all()
    full, tc2 = models.decode_step(tp, cfg, _filled_caches(arch, layers, t)[1],
                                   torch.from_numpy(toks).long(), _pos(pos))
    assert torch.equal(full[:, -1], tl)
    if where == "inside":
        li, tc3 = make_decode_step(cfg)(tp, _filled_caches(arch, layers,
                                                           t)[1],
                                        torch.from_numpy(toks).long(), pos)
        assert torch.equal(li, tl)
        for a, b in zip(tree_flatten(tc3)[0], tree_flatten(tc)[0]):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="does not fit"):
            models.decode_step(tp, cfg, tc2, torch.from_numpy(toks).long(),
                               pos)


@pytest.mark.parametrize("t,pos,window", [(2, 40, 0), (17, 40, 16),
                                          (64, 9, 0), (64, 23, 16),
                                          (17, 69, 0)])
def test_decode_attention_dyn_device_pos_matches_reference(t, pos, window):
    """``decode_attention_dyn`` over a whole cache at a 0-d int32 ``pos``
    (past the cache's end too) against the reference's at
    ``jnp.int32(pos)`` within FN_ATOL, bit-equal to the host int; B4's
    plain form on the cache's ``transpose(1, 2)`` views at that tensor
    offset, bit-equal to the host int, within FN_ATOL of the same."""
    q, k, v = _attn_inputs(1000 + t + pos, t=t, s=CHUNK_SEQ)
    want = jtransformer.decode_attention_dyn(*map(jnp.asarray, (q, k, v)),
                                             jnp.int32(pos), window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = transformer.decode_attention_dyn(tq, tk, tv, _pos(pos), window)
    assert torch.equal(got, transformer.decode_attention_dyn(
        tq, tk, tv, pos, window))
    assert _gap(got, want) <= FN_ATOL
    views = (tq.transpose(1, 2).contiguous(), tk.transpose(1, 2),
             tv.transpose(1, 2))
    assert not views[1].is_contiguous()
    fa.reset_counts()
    b4 = fa.flash_attention(*views, window=window, q_offset=_pos(pos))
    assert torch.equal(b4, fa.flash_attention(*views, window=window,
                                              q_offset=pos))
    assert fa.plain_count() == 2 and fa.launch_count() == 0
    assert _gap(b4.transpose(1, 2), want) <= FN_ATOL


# --------------------------------- generate ----------------------------------
@pytest.mark.parametrize("arch", list(dict.fromkeys(a for a, _ in ARCHS))
                         + ["encdec"])
def test_chunkable_matches_reference(arch):
    from dataclasses import replace
    if arch == "encdec":                 # an encoder-decoder never chunks
        cfg = replace(get_config("phi3-mini-3.8b"), encoder_layers=2)
        jcfg = replace(jget_config("phi3-mini-3.8b"), encoder_layers=2)
    else:
        cfg, jcfg = get_config(arch), jget_config(arch)
    assert serve.chunkable(cfg) == jchunkable(jcfg)


@pytest.mark.parametrize("stepped", [False, True], ids=["chunked", "stepped"])
@pytest.mark.parametrize("arch,layers", ARCHS)
def test_generate_matches_reference(arch, layers, stepped):
    """Greedy tokens identical to the reference's ``generate``; the chunked
    and stepped prefills give the same tokens (recurrent archs always
    step)."""
    cfg, _, _, tp, tok = _setup(arch, layers)
    want = _jgenerate(arch, layers, stepped or not jchunkable(
        _setup(arch, layers)[1]))
    got, logits = serve.generate(cfg, tp, torch.from_numpy(tok).long(),
                                 gen=GEN, max_seq=MAX_SEQ,
                                 stepped_prefill=stepped, return_logits=True)
    assert got.shape == (BATCH, PROMPT + GEN) and logits.shape == (
        BATCH, GEN, cfg.vocab_size)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want[:, PROMPT:])


def test_generate_refuses_sampling(capsys):
    """Sampling without a key is refused; with one it draws (against the
    reference in tests/test_torch_sampling.py).  The static CLI decodes
    greedily whatever ``--temperature`` says, as the reference's CLI does
    (ROADMAP C14), and says so."""
    from repro_torch.core import prng
    cfg, _, _, tp, tok = _setup("phi3-mini-3.8b", 2)
    with pytest.raises(ValueError, match="needs rng"):
        serve.generate(cfg, tp, torch.from_numpy(tok), gen=2,
                       max_seq=PROMPT + 2, greedy=False)
    got = serve.generate(cfg, tp, torch.from_numpy(tok).long(), gen=2,
                         max_seq=PROMPT + 2, greedy=False,
                         rng=prng.PRNGKey(0))
    assert got.shape == (BATCH, PROMPT + 2)
    argv = ["--device", "cpu", "--batch", "2", "--prompt-len", "5", "--gen",
            "3"]
    greedy = serve.run(argv)
    capsys.readouterr()
    hot = serve.run(argv + ["--temperature", "0.5"])
    assert torch.equal(hot, greedy)
    assert "decodes greedily" in capsys.readouterr().out


def test_static_cli(capsys):
    toks = serve.run(["--arch", "rwkv6-7b", "--device", "cpu", "--batch",
                      "2", "--prompt-len", "5", "--gen", "3"])
    assert toks.shape == (2, 8)
    assert "arch=rwkv6-7b-reduced batch=2" in capsys.readouterr().out


# -------------------------- the kernels' plain forms --------------------------
def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bf16" else np.float32


@pytest.mark.parametrize("hd", [80, 96])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pos,window", [(0, 0), (37, 0), (63, 16)])
def test_flash_decode_strided_cache_matches_reference(hd, dt, pos, window):
    """B5 on the ``(B, S, KV, hd)`` layer cache read through its
    ``transpose(1, 2)`` view, against the reference's oracle
    (``REF`` 1e-6; bf16 q one bf16 ulp more) and its Pallas kernel in
    interpret mode (2e-5) on the contiguous ``(B, KV, S, hd)`` copy."""
    rng = np.random.default_rng(hd + pos)
    b, h, kv, s = 2, 4, 2, 64
    q = rng.standard_normal((b, h, 1, hd)).astype(_np_dtype(dt))
    kc, vc = (rng.standard_normal((b, s, kv, hd)).astype(_np_dtype(dt))
              for _ in range(2))
    tk, tv = (tensor_from_numpy(a, "cpu").transpose(1, 2) for a in (kc, vc))
    assert not tk.is_contiguous()
    fd.reset_counts()
    got = fd.flash_decode(tensor_from_numpy(q, "cpu"), tk, tv, pos,
                          window=window).float().numpy()
    assert fd.plain_count("flash_decode") == 1 and fd.launch_count() == 0
    jk, jv = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (kc, vc))
    oracle = np.asarray(jref.flash_decode_ref(jnp.asarray(q), jk, jv, pos,
                                              window=window), np.float32)
    pallas = np.asarray(jfd.flash_decode(jnp.asarray(q), jk, jv, pos,
                                         window=window, interpret=True),
                        np.float32)
    ulp = (np.abs(oracle) * 2.0 ** -7) if dt == "bf16" else 0.0
    assert (np.abs(got - oracle) <= 1e-6 + ulp).all()
    assert (np.abs(got - pallas) <= 2e-5 + ulp).all()


@pytest.mark.parametrize("t,offset,window", [(1, 0, 0), (1, 17, 0),
                                             (5, 1, 0), (5, 17, 8),
                                             (5, 17, 0), (12, 0, 4)])
def test_flash_attention_offset_matches_reference(t, offset, window):
    """B4 with a query offset (queries at offset..offset+T-1 over the first
    offset + T keys), its plain form on CPU tensors, against the
    reference's ``decode_attention_dyn`` over a longer cache (the keys past
    offset + T must not count) within FN_ATOL."""
    rng = np.random.default_rng(100 + offset + t)
    b, h, kv, hd, s = 2, 4, 2, 16, offset + t + 7
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s, kv, hd)).astype(np.float32)
              for _ in range(2))
    want = jtransformer.decode_attention_dyn(
        *map(jnp.asarray, (q, kc, vc)), jnp.int32(offset), window)
    n = offset + t
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  for a in (q, kc[:, :n], vc[:, :n]))
    fa.reset_counts()
    got = fa.flash_attention(tq, tk, tv, window=window, q_offset=offset)
    assert fa.plain_count() == 1 and fa.launch_count() == 0
    assert _gap(got.transpose(1, 2), want) <= FN_ATOL
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(tq, tk, tv, q_offset=-1)


# ------------------------------ planted faults -------------------------------
def _window_off_by_one(orig):
    def dyn(q, k_cache, v_cache, pos, window):
        return orig(q, k_cache, v_cache, pos, window + 1 if window else 0)
    return dyn


def _global_given_local_window(orig, window):
    def dyn(q, k_cache, v_cache, pos, w):
        return orig(q, k_cache, v_cache, pos, w or window)
    return dyn


def _step_without_u(orig):
    def step(S, r, k, v, w, u):
        return orig(S, r, k, v, w, torch.zeros_like(u))
    return step


@pytest.mark.parametrize("fault", ["window_off_by_one", "u_dropped",
                                   "global_given_local_window"])
def test_planted_fault_breaks_the_band(monkeypatch, fault):
    arch, layers = {"window_off_by_one": ("gemma3-4b", 2),
                    "u_dropped": ("rwkv6-7b", 2),
                    "global_given_local_window": ("gemma3-4b", 6)}[fault]
    want = _stepped(arch, layers)[1]          # before the fault is planted
    if fault == "window_off_by_one":
        monkeypatch.setattr(transformer, "decode_attention_dyn",
                            _window_off_by_one(
                                transformer.decode_attention_dyn))
    elif fault == "global_given_local_window":
        cfg = _setup(arch, layers)[0]
        assert 0 in transformer.layout(cfg)[0].windows
        monkeypatch.setattr(transformer, "decode_attention_dyn",
                            _global_given_local_window(
                                transformer.decode_attention_dyn,
                                cfg.attn_window))
    else:
        monkeypatch.setattr(rwkv6, "wkv6_step",
                            _step_without_u(rwkv6.wkv6_step))
    cfg, _, _, tp, tok = _setup(arch, layers)
    tc = models.init_cache(cfg, BATCH, MAX_SEQ, device="cpu")
    got = []
    for t in range(PROMPT):
        lt, tc = models.decode_step(tp, cfg, tc,
                                    torch.from_numpy(tok[:, t:t + 1]), t)
        got.append(lt.numpy())
    gap = _gap(np.concatenate(got, 1), want)
    assert gap > 10 * BAND, gap
