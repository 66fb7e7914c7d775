"""The port's threefry-keyed sampling (``core.prng``) and the sampled
serving paths against the JAX package's, on the CPU.

* Key stream, bit for bit with ``jax.random``: ``PRNGKey`` over seeds
  that include 0, -1, 2**31 - 1, 2**32 + 5 and -(2**40) (hypothesis over
  the int64 range), ``fold_in`` on int32 tensors that include negative
  values (bit-cast as JAX casts a traced int32) and chained as the engine
  chains ``(seed, rid, step)``, ``random_bits`` of 32 and 8 bits over 1-D
  and 2-D shapes.
* Uniforms bit for bit in f32 and bf16.  bf16 Gumbel noise bit for bit:
  its uniform takes 128 values and every one of them is drawn.  f32
  Gumbel noise within ``GUMBEL_F32_BAND`` (below), and apart somewhere, so
  the band is not vacuous.
* ``categorical`` with one key over a ``(B, V)`` batch and in the
  reference's per-row ``vmap`` form: the same tokens, except where the
  perturbed logits tie within the band (none in bf16).  A chi-square
  test: 4,096 keyed draws from one row follow ``softmax(lo / T)`` over
  its top-k.
* ``paged.make_token_fn``'s selection on the same logits as the
  reference's (the two serve steps swapped for one that returns them).
* Sampled ``ServeEngine`` (T 0.8 with top-k 32, T 0.9 without; paged and
  contiguous) and sampled ``generate`` (phi3's chunked prefill, rwkv6's
  stepped one) on reduced f32 models with the reference's weights carried
  over: teacher-forced on the reference's stream, every step picks the
  reference's token or lies within the band of it; replays the same under
  staggered and simultaneous arrival; another seed, another stream.

The f32 band.  ``torch.log`` and XLA:CPU's ``log`` round apart in about a
quarter of the draws, by one ulp of the result (the 4.8e-7 first seen is
one ulp of ``g`` in [4, 8)); the low-mode noise reaches ``|g| < 23 ln 2 <
16``, where one ulp is 2**-20 = 9.5e-7.  The inner log's rounding carries
into ``g`` as an absolute error of about its relative one (2**-23 a side).
So ``|g_port - g_jax| <= ulp(|g|) + 2**-22``, at most ``GUMBEL_F32_BAND``
= 2**-20 + 2**-22 = 1.19e-6 (3 M draws here: 9.5e-7 at most).  A pick
compares ``z = lo * (1 / T) + g``: the two packages round the product and
the sum, and XLA may fuse them into one FMA, so each ``z`` moves by up to
``2 ulp(|z|)`` more, and by the logits' own gap over T where the two
packages computed the logits.  Two picks that differ therefore lie within
twice that sum of each other (``_z_band``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from scipy import stats

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.serve import generate as jgenerate
from repro.serve import PageSpec as JPageSpec
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import paged as jpg
from repro.serve import repetitive_workload as jrepetitive
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.serve import (PageSpec, Request, ServeEngine,
                               repetitive_workload)
from repro_torch.serve import paged as pg

torch.set_num_threads(1)

GUMBEL_F32_BAND = 2.0 ** -20 + 2.0 ** -22
# the logits' gap between the two packages (tests/test_torch_serve.py
# SERVE_BAND, tests/test_torch_decode.py BAND)
SERVE_LOGIT_BAND, DECODE_LOGIT_BAND = 5e-5, 1e-4
SEEDS = (0, -1, 2 ** 31 - 1, 2 ** 32 + 5, -(2 ** 40))
INT32 = st.integers(-2 ** 31, 2 ** 31 - 1)
SPEC = dict(page_len=8, pages_per_slot=10, n_slots=2)


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _z_band(z, logit_gap=0.0, temperature=1.0):
    """Twice the most one ``z`` can move between the two packages."""
    return 2 * (logit_gap / temperature + GUMBEL_F32_BAND
                + 2 * float(_ulp(np.abs(z).max())))


def _check_pick(z, got, want, band):
    """``got`` is the port's pick on its perturbed logits ``z`` (1-D);
    ``want`` the reference's.  Equal, or within ``band`` of it."""
    z = np.asarray(z, np.float64)
    if got == want:
        return 0
    gap = z[got] - z[want]
    assert 0 <= gap <= band, (got, want, gap, band)
    return 1


# ----------------------------- the key stream -------------------------------
@settings(max_examples=40, deadline=None)
@given(st.integers(-2 ** 63, 2 ** 63 - 1))
@example(0)
@example(-1)
@example(2 ** 31 - 1)
@example(2 ** 32 + 5)
@example(-(2 ** 40))
def test_prngkey_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), _jkey(seed))


def test_prngkey_refuses_what_jax_refuses():
    for seed in (2 ** 63, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng.PRNGKey(seed)
    key = prng.PRNGKey(7)
    for d in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(7), d)
        with pytest.raises(OverflowError):
            prng.fold_in(key, d)
    with pytest.raises(TypeError):
        prng.fold_in(key, torch.tensor([1.0]))
    with pytest.raises(TypeError):
        prng.gumbel(key, (3,), torch.float16)


_jfold = jax.jit(jax.vmap(jax.random.fold_in, in_axes=(None, 0)))
_jfold2 = jax.jit(jax.vmap(jax.vmap(jax.random.fold_in)))


@settings(max_examples=30, deadline=None)
@given(st.integers(-2 ** 63, 2 ** 63 - 1),
       st.lists(INT32, min_size=8, max_size=8),
       st.lists(INT32, min_size=8, max_size=8))
@example(0, [0, -1, 2 ** 31 - 1, -2 ** 31, 3, 11, -5, 1],
         [-3, -1, 0, 1, 2 ** 31 - 1, -2 ** 31, 7, 64])
def test_fold_in_matches_jax(seed, rids, steps):
    """fold_in on int32 tensors (negative ones bit-cast), then chained
    per (rid, step) as the engine derives its keys, against JAX's."""
    rids, steps = np.asarray(rids, np.int32), np.asarray(steps, np.int32)
    for s in (seed,) + SEEDS[:1]:
        key, jk = prng.PRNGKey(s), jax.random.PRNGKey(s)
        kr = prng.fold_in(key, torch.from_numpy(rids))
        jkr = _jfold(jk, jnp.asarray(rids))
        np.testing.assert_array_equal(kr.numpy(),
                                      np.asarray(jkr).astype(np.int64))
        ks = prng.fold_in(kr[:, None], torch.from_numpy(steps)[:, None]
                          + torch.arange(2))
        jks = _jfold2(jnp.broadcast_to(jkr[:, None], (8, 2, 2)),
                      jnp.asarray(steps)[:, None] + jnp.arange(2))
        np.testing.assert_array_equal(ks.numpy(),
                                      np.asarray(jks).astype(np.int64))
    # a Python int in range, and the check value of the derivation
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(seed), 2 ** 32 - 1).numpy(),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                      2 ** 32 - 1)).astype(np.int64))
    assert prng.fold_in(prng.fold_in(prng.PRNGKey(7), 3), 11).tolist() == \
        [2993013290, 2155940137]


@settings(max_examples=15, deadline=None)
@given(st.integers(-2 ** 63, 2 ** 63 - 1))
@example(0)
@example(-1)
@example(2 ** 32 + 5)
@example(-(2 ** 40))
def test_random_bits_match_jax(seed):
    key, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((1000,), (3, 5), (7, 129)):
        for width, dt in ((32, jnp.uint32), (8, jnp.uint8)):
            got = prng.random_bits(key, width, shape).numpy()
            want = np.asarray(jax.random.bits(jk, shape, dt))
            assert got.shape == shape
            np.testing.assert_array_equal(got, want.astype(np.int64))
    # a batch of keys: each row its own draw
    keys = prng.fold_in(key, torch.arange(3))
    np.testing.assert_array_equal(
        prng.random_bits(keys, 32, (4, 5))[1].numpy(),
        np.asarray(jax.random.bits(jax.random.fold_in(jk, 1), (4, 5),
                                   jnp.uint32)).astype(np.int64))


# ----------------------------- uniform and Gumbel ---------------------------
def _np(t):
    return (t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_bit_equal(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    for seed in SEEDS:
        key, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        got = _np(prng.uniform(key, (20000,), tdt))
        want = _jnp(jax.random.uniform(jk, (20000,), jdt))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        tiny = float(torch.finfo(tdt).tiny)
        got = _np(prng.uniform(key, (50, 40), tdt, tiny, 1.0))
        want = _jnp(jax.random.uniform(jk, (50, 40), jdt, tiny, 1.0))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert got.min() >= tiny and got.max() < 1


def test_bf16_gumbel_bit_equal_on_every_uniform():
    """bf16 noise takes one of 128 values (its uniform's 7 random bits);
    20,000 draws reach every one, and each equals JAX's bit for bit."""
    key, jk = prng.PRNGKey(5), jax.random.PRNGKey(5)
    u = _np(prng.uniform(key, (20000,), torch.bfloat16,
                         float(torch.finfo(torch.bfloat16).tiny), 1.0))
    assert len(np.unique(u)) == 128
    got = _np(prng.gumbel(key, (20000,), torch.bfloat16))
    want = _jnp(jax.random.gumbel(jk, (20000,), jnp.bfloat16))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # rounding the f32 log once, at the end, would not be JAX's noise
    u32 = torch.from_numpy(u)
    once = u32.log().neg().log().neg().bfloat16().float().numpy()
    assert (once != want).any()


def test_f32_gumbel_within_band():
    worst = 0.0
    for seed in (0, 1, 2):
        key, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        got = prng.gumbel(key, (1_000_000,)).numpy().astype(np.float64)
        want = np.asarray(jax.random.gumbel(jk, (1_000_000,)), np.float64)
        d = np.abs(got - want)
        assert (d <= _ulp(want) + 2.0 ** -22).all()
        assert 0.1 < (d > 0).mean() < 0.5        # apart: the band is real
        assert np.abs(want).max() < 16
        worst = max(worst, float(d.max()))
    assert worst <= GUMBEL_F32_BAND


# ----------------------------- categorical ----------------------------------
_jcat_rows = jax.jit(jax.vmap(jax.vmap(jax.random.categorical)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_categorical_one_key_over_the_batch(dtype):
    """One key over a (B, V) batch (the static generate's draw): counters
    over b * V + v."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    near = 0
    for seed in range(12):
        lo = (rng.standard_normal((4, 3000)) * 2).astype(np.float32)
        tl = torch.from_numpy(lo).to(tdt)
        jl = jnp.asarray(lo).astype(jdt)
        key, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
        got = prng.categorical(key, tl).numpy()
        want = np.asarray(jax.random.categorical(jk, jl))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
            continue
        z = (prng.gumbel(key, tl.shape) + tl).numpy()
        for b in range(4):
            near += _check_pick(z[b], got[b], want[b], _z_band(z[b]))
    assert near <= 2


def test_categorical_per_row_keys():
    """The reference's serving draw: a key per (row, chunk position),
    ``jax.vmap`` of ``categorical``, counters over the row alone."""
    rng = np.random.default_rng(1)
    near = 0
    for seed in range(6):
        lo = (rng.standard_normal((3, 4, 2000)) * 2).astype(np.float32)
        rids = np.array([0, -7, 123], np.int32)
        steps = np.arange(12, dtype=np.int32).reshape(3, 4) - 2
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(seed),
                                          torch.from_numpy(rids))[:, None],
                            torch.from_numpy(steps))
        jkeys = _jfold2(jnp.broadcast_to(
            _jfold(jax.random.PRNGKey(seed), jnp.asarray(rids))[:, None],
            (3, 4, 2)), jnp.asarray(steps))
        np.testing.assert_array_equal(keys.numpy(),
                                      np.asarray(jkeys).astype(np.int64))
        got = prng.categorical(keys, torch.from_numpy(lo)).numpy()
        want = np.asarray(_jcat_rows(jkeys, jnp.asarray(lo)))
        z = (prng.gumbel(keys, lo.shape[-1:]) + torch.from_numpy(lo)).numpy()
        for i in np.ndindex(3, 4):
            near += _check_pick(z[i], got[i], want[i], _z_band(z[i]))
        bf = torch.from_numpy(lo).bfloat16()
        np.testing.assert_array_equal(
            prng.categorical(keys, bf).numpy(),
            np.asarray(_jcat_rows(jkeys, jnp.asarray(lo).astype(
                jnp.bfloat16))))
    assert near <= 2
    with pytest.raises(ValueError, match="fit neither"):
        prng.categorical(keys[:2], torch.from_numpy(lo))


def test_sampled_frequencies_follow_the_truncated_softmax():
    """4,096 keyed draws (one key per step, as a request's stream) from
    one row of 12 logits at T 0.7 with top-k 5: no draw outside the top 5,
    and their counts pass a chi-square test against softmax(lo / T) over
    the top 5 (p > 1e-3)."""
    lo = torch.tensor([0.3, -1.0, 2.0, 0.9, 1.7, -0.4, 1.1, 0.0, 1.9, -2.0,
                       0.6, 1.2])
    t, k, n = 0.7, 5, 4096
    kth = torch.topk(lo, k).values[-1]
    cut = torch.where(lo >= kth, lo, pg.NEG_INF) * (1 / t)
    keys = prng.fold_in(prng.fold_in(prng.PRNGKey(3), 17),
                        torch.arange(n))
    picks = prng.categorical(keys, cut.expand(n, -1)).numpy()
    top = np.flatnonzero((lo >= kth).numpy())
    assert set(np.unique(picks)) <= set(top)
    p = torch.softmax(lo[top] / t, 0).numpy().astype(np.float64)
    counts = np.bincount(picks, minlength=12)[top]
    assert counts.sum() == n
    assert stats.chisquare(counts, p / p.sum() * n).pvalue > 1e-3
    # the same draws without the truncation reach beyond the top 5
    wide = prng.categorical(keys, (lo / t).expand(n, -1)).numpy()
    assert not set(np.unique(wide)) <= set(top)


def test_draws_copy_nothing_from_the_host(monkeypatch):
    """A draw builds no tensor from host values (``torch.tensor`` on the
    card copies from the host and waits for the stream): constants are
    filled on the device, so the draws of a decode loop queue without a
    sync.  Key derivation, noise in both dtypes, ``categorical`` and the
    engine's ``sample_tokens`` run with ``torch.tensor`` refused."""
    key = prng.PRNGKey(3)
    scale = torch.ones(()) / torch.tensor(0.8)
    lo = torch.randn(2, 3, 50, generator=torch.Generator().manual_seed(0))

    def refuse(*a, **kw):
        raise AssertionError("a tensor from host values")
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    keys = prng.fold_in(prng.fold_in(key, 5), torch.arange(4))
    prng.categorical(keys[0], lo[0].bfloat16())
    prng.categorical(keys[:2, None].expand(2, 3, 2), lo)
    pg.sample_tokens(lo, key, scale, 7, torch.arange(2), torch.arange(2) - 1)


# ----------------------------- make_token_fn ---------------------------------
def _token_fns(monkeypatch, temperature, top_k, seed):
    """Both packages' ``make_token_fn`` with the serve step swapped for
    one that returns the logits passed in as ``caches``."""
    monkeypatch.setattr(jpg, "make_serve_step", lambda *a, **kw: (
        lambda p, c, rows, lengths, active, tokens: (c, c)))
    monkeypatch.setattr(pg, "make_serve_step", lambda *a, **kw: (
        lambda p, c, rows, lengths, active, tokens: (c, c)))
    kw = dict(temperature=temperature, top_k=top_k, seed=seed)
    return (jax.jit(jpg.make_token_fn(None, None, **kw)),
            pg.make_token_fn(None, None, **kw))


@pytest.mark.parametrize("temperature,top_k", [(0.8, 32), (0.9, 0),
                                               (1.0, 5), (0.0, 0)])
def test_token_fn_selection_matches_reference(monkeypatch, temperature,
                                              top_k):
    """The selection of ``make_token_fn`` on the same logits: (m, T) rows
    with negative steps (the prefill's padding) and negative rids."""
    jfn, tfn = _token_fns(monkeypatch, temperature, top_k, seed=11)
    rng = np.random.default_rng(2)
    near = 0
    for trial in range(4):
        lo = (rng.standard_normal((4, 3, 700)) * 3).astype(np.float32)
        lo[0, 0, 5] = lo[0, 0].max()                 # a tie at the top
        rids = rng.integers(-3, 50, 4).astype(np.int32)
        steps0 = rng.integers(-4, 30, 4).astype(np.int32)
        want = np.asarray(jfn(None, jnp.asarray(lo), 0, 0, 0, 0,
                              jnp.asarray(rids), jnp.asarray(steps0))[0])
        # the port's token fn places its uploads on the embedding's device
        got, logits, _ = tfn({"embed": torch.zeros(0)}, torch.from_numpy(lo),
                             0, 0, 0, 0, rids, steps0)
        assert got.dtype == torch.int32 and got.shape == (4, 3)
        got = got.numpy()
        if temperature == 0.0:
            np.testing.assert_array_equal(got, want)
            continue
        cut = torch.from_numpy(lo)
        if top_k:
            kth = torch.topk(cut, top_k).values[..., -1:]
            cut = torch.where(cut >= kth, cut, pg.NEG_INF)
        steps = torch.from_numpy(steps0).long()[:, None] + torch.arange(3)
        keys = prng.fold_in(prng.fold_in(prng.PRNGKey(11), torch.from_numpy(
            rids))[:, None], steps)
        z = (cut * (1 / np.float32(temperature))
             + prng.gumbel(keys, (700,))).numpy()
        np.testing.assert_array_equal(got, z.argmax(-1))
        for i in np.ndindex(4, 3):
            near += _check_pick(z[i], got[i], want[i], _z_band(z[i][z[i]
                                                                > -1e29]))
            if top_k:
                assert (lo[i] >= np.sort(lo[i])[-top_k]).sum() >= top_k
                assert lo[i][got[i]] >= np.sort(lo[i])[-top_k]
    assert near <= 1


def test_token_fn_refuses_bad_settings():
    spec = PageSpec(**SPEC)
    cfg = reduced(get_config("phi3-mini-3.8b"))
    with pytest.raises(ValueError, match="temperature"):
        pg.make_token_fn(cfg, spec, temperature=-0.1)
    with pytest.raises(ValueError, match="top_k"):
        pg.make_token_fn(cfg, spec, temperature=0.5, top_k=-1)


# ----------------------------- the sampled engine ---------------------------
@pytest.fixture(scope="module", params=("gemma3-4b", "phi3-mini-3.8b"))
def model(request):
    """(reference cfg, reference params, port cfg, port params)."""
    arch = request.param
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, tparams


def _reqs(cfg, n=4):
    kw = dict(vocab=cfg.vocab_size, prompt_len=12, gen=(8, 14))
    return repetitive_workload(3, n, **kw), jrepetitive(3, n, **kw)


def _toks(recs):
    return {r.rid: tuple(r.tokens) for r in recs}


def _teacher_force(engine, want):
    """Feed ``engine`` the reference's tokens ``want`` (rid -> tokens):
    each selected token is swapped for the reference's at its (rid,
    step), the port's own pick and logits logged by (rid, step) (a
    prompt's earlier chunks also draw at step 0, as the reference's do;
    its last chunk's draw is the one kept)."""
    seen = {}
    for name in ("_tok_fn", "_row_tok_fn"):
        inner = getattr(engine, name)

        def forced(params, caches, rows, lengths, active, tokens, rids,
                   steps0, inner=inner):
            toks, logits, caches = inner(params, caches, rows, lengths,
                                         active, tokens, rids, steps0)
            toks = toks.clone()
            for i, rid in enumerate(np.asarray(rids).tolist()):
                for j in range(int(active[i])):
                    s = int(steps0[i]) + j
                    if s >= 0 and rid in want:
                        seen[rid, s] = (int(toks[i, j]),
                                        logits[i, j].clone())
                        toks[i, j] = want[rid][s]
            return toks, logits, caches
        setattr(engine, name, forced)
    return seen


@pytest.mark.parametrize("backend", ["paged", "contig"])
@pytest.mark.parametrize("temperature,top_k", [(0.8, 32), (0.9, 0)])
def test_sampled_serve_matches_reference(model, backend, temperature, top_k):
    """The reference's sampled stream, teacher-forced into the port's
    engine: at every (rid, step) the port picks the reference's token or
    lies within the band of it; the logits within SERVE_LOGIT_BAND of the
    reference's.  (Run free, the port repeats the stream:
    ``test_sampled_replay_same_across_batching``.)"""
    jcfg, jparams, cfg, tparams = model
    reqs, jreqs = _reqs(cfg)
    kw = dict(backend=backend, prefill_chunk=8, temperature=temperature,
              top_k=top_k, sample_seed=11)
    je = JServeEngine(jcfg, jparams, spec=JPageSpec(**SPEC),
                      record_logits=True, **kw)
    jrecs = je.serve(jreqs)
    want = {r.rid: list(r.tokens) for r in jrecs}
    te = ServeEngine(cfg, tparams, spec=PageSpec(**SPEC), device="cpu", **kw)
    seen = _teacher_force(te, want)
    trecs = te.serve(reqs)
    assert _toks(trecs) == _toks(jrecs)
    assert len(seen) == sum(len(t) for t in want.values())
    jlog = {(r.rid, s): lg for r in jrecs for s, lg in enumerate(r.logits)}
    scale = 1 / np.float32(temperature)
    near = 0
    for (rid, s), (pick, lg) in seen.items():
        assert float(np.abs(lg.numpy() - jlog[rid, s]).max()) <= \
            SERVE_LOGIT_BAND
        lo = lg.clone()
        if top_k:
            kth = torch.topk(lo, top_k).values[-1]
            lo = torch.where(lo >= kth, lo, pg.NEG_INF)
        key = prng.fold_in(prng.fold_in(prng.PRNGKey(11), rid), s)
        z = (lo * scale + prng.gumbel(key, lo.shape)).numpy()
        assert int(z.argmax()) == pick
        near += _check_pick(z, pick, want[rid][s], _z_band(
            z[z > -1e29], SERVE_LOGIT_BAND, temperature))
    assert near <= 1
    assert te.log == je.log and te.stats == je.stats


def test_sampled_replay_same_across_batching(model):
    """Keyed on (seed, rid, step): the same requests admitted together or
    staggered, and through slot buckets or not, sample the same streams;
    the reference's engine gives them too."""
    jcfg, jparams, cfg, tparams = model
    reqs, jreqs = _reqs(cfg)
    together = [Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                        arrival=0) for r in reqs]
    kw = dict(prefill_chunk=8, temperature=0.8, top_k=32, sample_seed=11,
              device="cpu")
    a = ServeEngine(cfg, tparams, spec=PageSpec(**SPEC), **kw).serve(reqs)
    b = ServeEngine(cfg, tparams, spec=PageSpec(**SPEC), **kw).serve(
        together)
    c = ServeEngine(cfg, tparams, spec=PageSpec(**SPEC), slot_buckets=False,
                    **kw).serve(together)
    assert _toks(a) == _toks(b) == _toks(c)
    jtogether = [JRequest(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                          arrival=0) for r in jreqs]
    jb = JServeEngine(jcfg, jparams, spec=JPageSpec(**SPEC), prefill_chunk=8,
                      temperature=0.8, top_k=32, sample_seed=11)
    assert _toks(jb.serve(jtogether)) == _toks(b)


def test_sampled_seed_sensitivity(model):
    _, _, cfg, tparams = model
    reqs, _ = _reqs(cfg)
    runs = [_toks(ServeEngine(cfg, tparams, spec=PageSpec(**SPEC),
                              prefill_chunk=8, temperature=0.9,
                              sample_seed=s, device="cpu").serve(reqs))
            for s in (0, 1)]
    greedy = _toks(ServeEngine(cfg, tparams, spec=PageSpec(**SPEC),
                               prefill_chunk=8, device="cpu").serve(reqs))
    assert runs[0] != runs[1] and greedy not in runs


# ----------------------------- sampled generate -----------------------------
PROMPT, GEN, BATCH = 20, 6, 2


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "rwkv6-7b"])
def test_sampled_generate_matches_reference(arch, monkeypatch):
    """The reference's ``generate(greedy=False, rng=PRNGKey(5))`` on
    phi3 (chunked prefill) and rwkv6 (stepped): its stream teacher-forced
    into the port's, every step the reference's token or within the band;
    free, the same tokens."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      cfg, "cpu")
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    want = np.asarray(jgenerate(jcfg, jp, jnp.asarray(tok), gen=GEN,
                                max_seq=PROMPT + GEN, greedy=False,
                                rng=jax.random.PRNGKey(5)))
    real, seen = serve.prng.categorical, []

    def forced(key, logits):
        pick = real(key, logits)
        i = len(seen)
        seen.append((key.clone(), logits.clone(), pick.clone()))
        return torch.from_numpy(want[:, PROMPT + i].copy()).long()
    monkeypatch.setattr(serve.prng, "categorical", forced)
    got, logits = serve.generate(cfg, tp, torch.from_numpy(tok).long(),
                                 gen=GEN, max_seq=PROMPT + GEN, greedy=False,
                                 rng=prng.PRNGKey(5), return_logits=True)
    monkeypatch.setattr(serve.prng, "categorical", real)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(seen) == GEN
    near = 0
    for i, (key, lg, pick) in enumerate(seen):
        assert key.tolist() == np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(5), PROMPT + i)).tolist()
        z = (prng.gumbel(key, lg.shape) + lg).numpy()
        for b in range(BATCH):
            near += _check_pick(z[b], int(pick[b]), int(want[b, PROMPT + i]),
                                _z_band(z[b], DECODE_LOGIT_BAND))
    assert near <= 1
    free = serve.generate(cfg, tp, torch.from_numpy(tok).long(), gen=GEN,
                          max_seq=PROMPT + GEN, greedy=False,
                          rng=prng.PRNGKey(5))
    if near == 0:
        np.testing.assert_array_equal(free.numpy(), want)
    other = serve.generate(cfg, tp, torch.from_numpy(tok).long(), gen=GEN,
                           max_seq=PROMPT + GEN, greedy=False,
                           rng=prng.PRNGKey(6))
    assert not torch.equal(other, free)


def test_sampled_generate_bf16_noise_is_the_references():
    """bf16 logits (the full-width models' dtype): one key over the batch
    draws bf16 noise, bit-equal to JAX's, so the picks are JAX's on the
    same logits without exception."""
    rng = np.random.default_rng(4)
    lo = (rng.standard_normal((4, 32064)) * 3).astype(np.float32)
    for t in (512, 513, 575):
        key = prng.fold_in(prng.PRNGKey(0), t)
        jk = jax.random.fold_in(jax.random.PRNGKey(0), t)
        got = prng.categorical(key, torch.from_numpy(lo).bfloat16())
        want = jax.random.categorical(jk, jnp.asarray(lo).astype(
            jnp.bfloat16))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
