"""The port's paged serving engine against the JAX package, on the CPU.

Both packages run reduced ``gemma3-4b`` (two layers with a uniform window
of 16, GQA n_rep 2; the fixture of the reference's serving tests; and, for
the step, the whole serve run and paged-vs-contig parity, six layers: five
local, then the global one, a segment of mixed windows), reduced
``phi3-mini-3.8b`` (two global layers, MHA) and the wide-GQA configs
reduced to keep their group widths: ``llama3-405b`` (16 query heads over
one KV head, RoPE theta 500,000), ``deepseek-67b`` (8 over 1) and
``arctic-480b`` (7 over 1; 4 experts, top-2, the dense residual, served
with ``moe_ffn(dropless=True)``), in f32, with the reference's parameters
carried over by ``convert.lm_params_from_numpy``.

* Layers: ``rms_norm``, ``apply_rope`` and ``swiglu`` within ``LAYER_TOL``
  (measured 4.8e-7 for the first two; swiglu 1.3e-5 on outputs of
  magnitude about 20, so it is held relative to its output's scale).
* One ``make_serve_step`` call, teacher-forced on the same caches, rows,
  lengths and tokens, for the decode ``(m, 1)``, prefill ``(1, C)`` and
  verify ``(m, k+1)`` shapes, with sentinel table entries and a dead row:
  logits and updated caches within ``STEP_TOL`` (measured at most 5.1e-6
  on logits, 4.1e-6 on caches); every cache position the reference
  leaves untouched stays bit for bit.
* ``run_serve_loop``'s schedule log equal to the reference's, exactly.
* Whole ``ServeEngine.serve`` runs, paged and contiguous: greedy token
  streams identical, logits within ``SERVE_BAND`` (measured at most
  6.1e-6), and every emitted token's top-2 logit margin larger than the
  measured gap (the smallest margin is 3.1e-3), so the identity is not
  luck; the same schedule, ``compile_log`` and counters.
* Within the port: paged and contiguous f32 (and bf16-page) logits bit
  for bit under churn, for the MoE config within
  ``MOE_PAGED_CONTIG_BAND`` with identical tokens (the reference's own two
  backends differ there too; ROADMAP C19); speculative decode and prefix
  sharing token-identical to one-token decode, with the reference's skip
  fraction.
* Planted faults (the RoPE sign flipped; a window of 8 for 16) break the
  step and serve bands.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import PageSpec as JPageSpec
from repro.serve import ServeEngine as JServeEngine
from repro.serve import paged as jpg
from repro.serve import (repetitive_workload as jrepetitive,
                         run_serve_loop as jrun_serve_loop,
                         shared_prefix_workload as jshared_prefix,
                         synthetic_workload as jsynthetic)
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers
from repro_torch.serve import (PageSpec, ServeEngine, repetitive_workload,
                               run_serve_loop, shared_prefix_workload,
                               synthetic_workload)
from repro_torch.serve import paged as pg

torch.set_num_threads(1)

ARCHS = ("gemma3-4b", "phi3-mini-3.8b", "llama3-405b", "deepseek-67b",
         "arctic-480b")
# the wide-GQA configs reduced to keep their group width: 16 query heads
# over one KV head (llama3), 8 over 1 (deepseek), 7 over 1 (arctic, 4
# experts, top-2, the dense residual)
GEOMETRY = {"llama3-405b": dict(n_heads=16, d_model=256),
            "deepseek-67b": dict(n_heads=8, d_model=256),
            "arctic-480b": dict(n_heads=7, d_model=224)}
LAYER_TOL = 2e-6
STEP_TOL = 2e-5
SERVE_BAND = 5e-5
# paged against contiguous in an MoE model (ROADMAP C19): not bit for bit
# in either package; the reference's own gap on the churn workload is
# 1.7e-6 on reduced arctic (1.9e-6 on reduced granite), with identical
# tokens
MOE_PAGED_CONTIG_BAND = 1e-5
CHURN_SPEC = dict(page_len=16, pages_per_slot=4, n_slots=2)


# gemma3 at 6 layers: five local layers (window 16), then the global one
# (``i % 6 == 5``), one attention segment of mixed windows, which the
# step serves through ``_slot_attention`` at each layer's own window
GEMMA_MIXED = "gemma3-4b-6-layers"
_MODELS = {}


def _model(key):
    """(arch, reference cfg, reference params, port cfg, port params)."""
    if key not in _MODELS:
        arch, layers = (("gemma3-4b", 6) if key == GEMMA_MIXED
                        else (key, 2))
        kw = dict(GEOMETRY.get(arch, {}), layers=layers)
        jcfg = jreduced(jget_config(arch), **kw)
        cfg = reduced(get_config(arch), **kw)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        _MODELS[key] = arch, jcfg, jparams, cfg, tparams
    return _MODELS[key]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=ARCHS + (GEMMA_MIXED,))
def served(request):
    """``model``, and gemma3 with its global layer (``GEMMA_MIXED``): the
    step, the whole serve run and paged-vs-contig parity."""
    return _model(request.param)


def _churn(vocab, seed=1, n=8):
    """The reference's churn workload: every slot of a 2-slot spec is
    recycled (tests/test_serve.py)."""
    kw = dict(prompt_lens=(3, 20), gen_short=(3, 8), gen_long=(12, 20),
              p_long=0.3)
    return (synthetic_workload(seed, n, vocab=vocab, **kw),
            jsynthetic(seed, n, vocab=vocab, **kw))


def _toks(recs):
    return {r.rid: tuple(r.tokens) for r in recs}


# ------------------------- layers ------------------------------------------
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4, 64)).astype(np.float32) * 2
    pos = rng.integers(0, 4096, (3, 7)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                             theta))
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta).numpy()
        assert np.abs(got - want).max() <= LAYER_TOL
    h = rng.standard_normal((3, 7, 256)).astype(np.float32) * 3
    g = rng.standard_normal(256).astype(np.float32) * 0.1
    want = np.asarray(jlayers.rms_norm(jnp.asarray(h), jnp.asarray(g)))
    got = layers.rms_norm(torch.from_numpy(h), torch.from_numpy(g)).numpy()
    assert np.abs(got - want).max() <= LAYER_TOL
    wi, wg, wo = (rng.standard_normal(s).astype(np.float32) * 0.06
                  for s in ((256, 512), (256, 512), (512, 256)))
    want = np.asarray(jlayers.swiglu(*map(jnp.asarray, (h, wi, wg, wo))))
    got = layers.swiglu(*map(torch.from_numpy, (h, wi, wg, wo))).numpy()
    assert np.abs(got - want).max() <= LAYER_TOL * np.abs(want).max()
    # bf16 in, bf16 out, computed in f32 as the reference
    hb = torch.from_numpy(h).bfloat16()
    assert layers.rms_norm(hb, torch.from_numpy(g)).dtype == torch.bfloat16


# ------------------------- one serve step ----------------------------------
def _step_case(kind, spec, cfg, seed):
    """(rows, lengths, active, tokens) for one step shape, with sentinel
    table entries past each row's pages and, for m > 1, a dead row."""
    rng = np.random.default_rng(seed)
    pp, n_pages = spec.pages_per_slot, spec.n_pages
    perm = rng.permutation(n_pages)
    if kind == "prefill":
        rows = np.full((1, pp), n_pages, np.int32)
        rows[0, :3] = perm[:3]
        lengths, active = np.array([19], np.int32), np.array([6], np.int32)
        t = 8
    else:
        t = 1 if kind == "decode" else 4
        m = spec.n_slots
        rows = perm[:m * pp].reshape(m, pp).astype(np.int32)
        rows[1, 2:] = n_pages                      # owns 2 pages
        rows[2] = n_pages                          # dead row
        lengths = np.array([40, 27, 0, 55][:m], np.int32)
        active = np.array([t, min(t, 3), 0, t][:m], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (rows.shape[0], t)) \
        .astype(np.int32)
    return rows, lengths, active, tokens


def _caches(cfg, spec, seed, backend):
    rng = np.random.default_rng(seed)
    shape = ((spec.n_pages, spec.page_len) if backend == "paged"
             else (spec.n_slots, spec.slot_tokens)) + (cfg.n_kv_heads,
                                                        cfg.head_dim)
    return [{"k": rng.standard_normal((cfg.n_layers,) + shape)
             .astype(np.float32),
             "v": rng.standard_normal((cfg.n_layers,) + shape)
             .astype(np.float32)}]


def _run_step(model, kind, backend, *, port_cfg=None, seed=0):
    """The reference's and the port's step on the same inputs; returns
    (want logits, got logits, caches before, want caches, got caches)."""
    _, jcfg, jparams, cfg, tparams = model
    spec = PageSpec(page_len=16, pages_per_slot=4, n_slots=4)
    jspec = JPageSpec(page_len=16, pages_per_slot=4, n_slots=4)
    rows, lengths, active, tokens = _step_case(kind, spec, cfg, seed)
    gather = backend == "contig" and kind == "prefill"
    if backend == "contig":
        rows = (np.array([1], np.int32) if gather
                else np.arange(spec.n_slots, dtype=np.int32))
    before = _caches(cfg, spec, seed + 1, backend)
    jstep = jpg.make_serve_step(jcfg, jspec, backend, gather_rows=gather)
    want, jc = jstep(jparams, jax.tree_util.tree_map(jnp.asarray, before),
                     *(jnp.asarray(a) for a in (rows, lengths, active,
                                                tokens)))
    tstep = pg.make_serve_step(port_cfg or cfg, spec, backend,
                               gather_rows=gather)
    tc = [{k: torch.from_numpy(v.copy()) for k, v in c.items()}
          for c in before]
    got, tc = tstep(tparams, tc, rows, lengths, active, tokens)
    return (np.asarray(want), got.numpy(), before,
            [{k: np.asarray(v) for k, v in c.items()} for c in jc],
            [{k: v.numpy() for k, v in c.items()} for c in tc])


@pytest.mark.parametrize("kind,backend", [("decode", "paged"),
                                          ("prefill", "paged"),
                                          ("verify", "paged"),
                                          ("decode", "contig"),
                                          ("prefill", "contig")])
def test_serve_step_matches_reference(served, kind, backend):
    want, got, before, jc, tc = _run_step(served, kind, backend)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= STEP_TOL
    for b, w, g in zip(before, jc, tc):
        for name in ("k", "v"):
            written = w[name] != b[name]
            assert written.any()
            np.testing.assert_array_equal(g[name] != b[name], written)
            np.testing.assert_array_equal(g[name][~written],
                                          b[name][~written])
            assert np.abs(g[name] - w[name]).max() <= STEP_TOL


def test_planted_faults_break_the_step_band(model, monkeypatch):
    """The RoPE sign flipped, or (gemma3) a window of 8 for 16: the
    decode step's logits leave STEP_TOL."""
    arch, _, _, cfg, _ = model
    real = pg.rope_tables

    def flipped(positions, hd, theta):
        cos, sin = real(positions, hd, theta)
        return cos, -sin
    monkeypatch.setattr(pg, "rope_tables", flipped)
    want, got, *_ = _run_step(model, "decode", "paged")
    assert np.abs(got - want).max() > 100 * STEP_TOL
    monkeypatch.setattr(pg, "rope_tables", real)
    if cfg.attn_window:
        wrong = dataclasses.replace(cfg, attn_window=8)
        want, got, *_ = _run_step(model, "decode", "paged", port_cfg=wrong)
        assert np.abs(got - want).max() > 100 * STEP_TOL


# ------------------------- the schedule ------------------------------------
class _Stub:
    def admit(self, slot, req, pages, **kw):
        pass

    def prefill(self, slot, req, chunk, pos, last):
        pass

    def decode(self, slots):
        pass

    def evict(self, slot, req):
        pass


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_schedule_log_matches_reference(policy):
    reqs, jreqs = _churn(512)
    got = run_serve_loop(reqs, PageSpec(**CHURN_SPEC), _Stub(),
                         prefill_chunk=8, policy=policy)
    want = jrun_serve_loop(jreqs, JPageSpec(**CHURN_SPEC), _Stub(),
                           prefill_chunk=8, policy=policy)
    assert got == want and len(got) > 30


def test_prefix_share_schedule_matches_reference():
    kw = dict(vocab=64, prefix_len=24, suffix_len=6, gen=(10, 14),
              p_dup=0.5, arrival_gap=2)
    spec = dict(page_len=8, pages_per_slot=10, n_slots=4)
    got = run_serve_loop(shared_prefix_workload(1, 6, **kw), PageSpec(**spec),
                         _Stub(), prefill_chunk=8, prefix_share=True)
    want = jrun_serve_loop(jshared_prefix(1, 6, **kw), JPageSpec(**spec),
                           _Stub(), prefill_chunk=8, prefix_share=True)
    assert got == want
    assert any(e[0] == "cow" for e in got)


# ------------------------- whole serve runs --------------------------------
def _serve_both(model, backend, **kw):
    _, jcfg, jparams, cfg, tparams = model
    reqs, jreqs = _churn(cfg.vocab_size)
    je = JServeEngine(jcfg, jparams, spec=JPageSpec(**CHURN_SPEC),
                      backend=backend, record_logits=True, prefill_chunk=8,
                      **kw)
    te = ServeEngine(cfg, tparams, spec=PageSpec(**CHURN_SPEC),
                     backend=backend, record_logits=True, prefill_chunk=8,
                     device="cpu", **kw)
    return je, je.serve(jreqs), te, te.serve(reqs)


def _gap_and_margin(jr, tr):
    gap = max(float(np.abs(x - y).max()) for a, b in zip(jr, tr)
              for x, y in zip(a.logits, b.logits))
    margin = min(float(np.diff(np.sort(y)[-2:])[0]) for b in tr
                 for y in b.logits)
    return gap, margin


@pytest.mark.parametrize("backend", ["paged", "contig"])
def test_serve_matches_reference(served, backend):
    je, jr, te, tr = _serve_both(served, backend)
    assert te.log == je.log
    assert te.compile_log == je.compile_log
    assert _toks(tr) == _toks(jr)
    assert all(len(a.logits) == len(b.logits) > 0 for a, b in zip(jr, tr))
    gap, margin = _gap_and_margin(jr, tr)
    assert gap <= SERVE_BAND
    assert margin > gap                     # the identity is not a tie
    assert te.stats == je.stats


def test_planted_fault_breaks_the_serve_band(model, monkeypatch):
    """gemma3: a window of 8 for 16; phi3 (no window): the RoPE sign
    flipped.  Either moves the logits far outside SERVE_BAND."""
    arch, jcfg, jparams, cfg, tparams = model
    reqs, jreqs = _churn(cfg.vocab_size)
    jr = JServeEngine(jcfg, jparams, spec=JPageSpec(**CHURN_SPEC),
                      record_logits=True, prefill_chunk=8).serve(jreqs)
    if cfg.attn_window:
        cfg = dataclasses.replace(cfg, attn_window=8)
    else:
        real = pg.rope_tables
        monkeypatch.setattr(pg, "rope_tables", lambda positions, hd, theta:
                            (lambda cs: (cs[0], -cs[1]))(
                                real(positions, hd, theta)))
    tr = ServeEngine(cfg, tparams, spec=PageSpec(**CHURN_SPEC),
                     record_logits=True, prefill_chunk=8,
                     device="cpu").serve(reqs)
    gap = max(float(np.abs(x - y).max()) for a, b in zip(jr, tr)
              for x, y in zip(a.logits, b.logits))
    assert gap > 100 * SERVE_BAND


# ------------------------- within the port ---------------------------------
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
def test_paged_contig_bit_parity_under_churn(served, store):
    _, _, _, cfg, tparams = served
    spec = (PageSpec(**CHURN_SPEC) if store == torch.float32 else
            PageSpec(page_len=32, pages_per_slot=2, n_slots=2,
                     store_dtype=store))
    reqs, _ = _churn(cfg.vocab_size, seed=1 if store == torch.float32
                     else 2, n=8 if store == torch.float32 else 5)
    pa = ServeEngine(cfg, tparams, spec=spec, backend="paged",
                     slot_buckets=False, record_logits=True, prefill_chunk=8,
                     device="cpu")
    co = ServeEngine(cfg, tparams, spec=spec, backend="contig",
                     record_logits=True, prefill_chunk=8, device="cpu")
    ra, rc = pa.serve(reqs), co.serve(reqs)
    assert pa.log == co.log
    assert len([e for e in pa.log if e[0] == "admit"]) > spec.n_slots
    for a, b in zip(ra, rc):
        assert a.tokens == b.tokens
        assert len(a.logits) == len(b.logits) > 0
        for la, lb in zip(a.logits, b.logits):
            if cfg.moe:
                assert np.abs(la - lb).max() <= MOE_PAGED_CONTIG_BAND
            else:
                assert np.array_equal(la, lb)


@pytest.mark.parametrize("backend", ["paged", "contig"])
def test_spec_decode_token_identity(model, backend):
    _, jcfg, jparams, cfg, tparams = model
    spec = PageSpec(page_len=8, pages_per_slot=10, n_slots=2)
    reqs = repetitive_workload(3, 6, vocab=cfg.vocab_size, prompt_len=12,
                               gen=(8, 14))
    base = ServeEngine(cfg, tparams, spec=spec, backend=backend,
                       prefill_chunk=8, device="cpu")
    fast = ServeEngine(cfg, tparams, spec=spec, backend=backend,
                       prefill_chunk=8, spec_k=3, device="cpu")
    assert _toks(base.serve(reqs)) == _toks(fast.serve(reqs))
    assert fast.stats["spec_dispatches"] > 0
    assert fast.stats["draft_proposed"] > 0
    # the reference's speculative engine on the same requests
    jfast = JServeEngine(jcfg, jparams,
                         spec=JPageSpec(page_len=8, pages_per_slot=10,
                                        n_slots=2),
                         backend=backend, prefill_chunk=8, spec_k=3)
    jreqs = jrepetitive(3, 6, vocab=cfg.vocab_size, prompt_len=12,
                        gen=(8, 14))
    assert _toks(jfast.serve(jreqs)) == _toks(fast.serve(reqs))
    assert fast.compile_log == jfast.compile_log
    assert fast.stats == jfast.stats


def test_prefix_share_token_identity_and_skip(model):
    _, jcfg, jparams, cfg, tparams = model
    kw = dict(vocab=cfg.vocab_size, prefix_len=24, suffix_len=6,
              gen=(10, 14), p_dup=0.5, arrival_gap=2)
    spec = dict(page_len=8, pages_per_slot=10, n_slots=4)
    reqs = shared_prefix_workload(1, 6, **kw)
    plain = ServeEngine(cfg, tparams, spec=PageSpec(**spec), prefill_chunk=8,
                        device="cpu")
    shared = ServeEngine(cfg, tparams, spec=PageSpec(**spec), prefill_chunk=8,
                         prefix_share=True, device="cpu")
    assert _toks(plain.serve(reqs)) == _toks(shared.serve(reqs))
    assert shared.stats["cow_copies"] >= 1
    assert plain.stats["prefill_skipped_tokens"] == 0
    jshared = JServeEngine(jcfg, jparams, spec=JPageSpec(**spec),
                           prefill_chunk=8, prefix_share=True)
    jrecs = jshared.serve(jshared_prefix(1, 6, **kw))
    assert shared.prefill_skip_frac == jshared.prefill_skip_frac >= 0.5
    assert _toks(jrecs) == _toks(shared.serve(reqs))


def test_engine_fences(model):
    _, _, _, cfg, tparams = model
    with pytest.raises(ValueError, match="greedy-only"):
        ServeEngine(cfg, tparams, spec_k=2, temperature=0.5, device="cpu")
    with pytest.raises(ValueError, match="page-table"):
        ServeEngine(cfg, tparams, backend="contig", prefix_share=True,
                    device="cpu")
    with pytest.raises(ValueError, match="in-step RNG"):
        ServeEngine(cfg, tparams, temperature=0.7, fused_sample=False,
                    device="cpu")
    # sampling itself builds and serves (tests/test_torch_sampling.py
    # holds its streams against the reference's)
    from repro_torch.serve import Request
    rec = ServeEngine(cfg, tparams, temperature=0.7, top_k=8, device="cpu")\
        .serve([Request(rid=0, tokens=(1, 2, 3), max_new=3)])[0]
    assert len(rec.tokens) == 3 and all(0 <= t < cfg.vocab_size
                                        for t in rec.tokens)
    with pytest.raises(ValueError, match="live on cpu"):
        ServeEngine(cfg, tparams, device="meta")


def test_lm_params_carry_over_both_ways():
    """bf16 and f32 leaves cross from the reference's tree to the port's
    and back bit for bit, key paths and stacking unchanged."""
    jcfg = dataclasses.replace(jreduced(jget_config("gemma3-4b")),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")),
                              param_dtype="bfloat16")
    jparams = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jcfg, jax.random.PRNGKey(1)))
    tparams = convert.lm_params_from_numpy(jparams, cfg, device="cpu")
    assert tparams["segments"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["final_norm"].dtype == torch.float32
    back = convert.params_to_numpy(tparams)
    flat_j, tree_j = jax.tree_util.tree_flatten(jparams)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    with pytest.raises(ValueError, match="segment"):
        convert.lm_params_from_numpy(
            jparams, dataclasses.replace(cfg, n_layers=3), device="cpu")


def test_fused_argmax_equals_host_argmax(model):
    _, _, _, cfg, tparams = model
    reqs, _ = _churn(cfg.vocab_size, seed=3, n=4)
    a = ServeEngine(cfg, tparams, spec=PageSpec(**CHURN_SPEC),
                    prefill_chunk=8, device="cpu")
    b = ServeEngine(cfg, tparams, spec=PageSpec(**CHURN_SPEC),
                    prefill_chunk=8, fused_sample=False, device="cpu")
    assert _toks(a.serve(reqs)) == _toks(b.serve(reqs))


def test_eos_early_stop_and_latency_records(model):
    from repro_torch.serve import Request
    _, _, _, cfg, tparams = model
    spec = PageSpec(page_len=16, pages_per_slot=6, n_slots=2)
    req = Request(rid=0, tokens=tuple(range(1, 8)), max_new=10)
    base = ServeEngine(cfg, tparams, spec=spec, prefill_chunk=8,
                       device="cpu").serve([req])[0]
    assert len(base.tokens) == 10
    assert base.t_first >= base.t_admit > 0 and base.tpot_s > 0
    assert base.t_done >= base.token_times[-1]
    eos = base.tokens[3]
    rec = ServeEngine(cfg, tparams, spec=spec, prefill_chunk=8, eos_id=eos,
                      device="cpu").serve([req])[0]
    assert rec.tokens == base.tokens[:base.tokens.index(eos) + 1]


def test_launch_serve_cli(capsys):
    from repro_torch.launch import serve as cli
    recs = cli.run(["--engine", "continuous", "--device", "cpu",
                    "--requests", "4", "--gen", "4"])
    assert len(recs) == 4 and "continuous requests=4" in capsys.readouterr().out
    # the static engine is the default (tests/test_torch_decode.py holds
    # its generate against the reference's)
    toks = cli.run(["--device", "cpu", "--batch", "2", "--gen", "4"])
    assert toks.shape == (2, 32 + 4)
    assert "arch=gemma3-4b-reduced batch=2" in capsys.readouterr().out
    # sampled: every token in the vocabulary, and the same streams again
    argv = ["--engine", "continuous", "--device", "cpu", "--requests", "4",
            "--gen", "4", "--temperature", "0.5", "--top-k", "8"]
    recs, again = cli.run(argv), cli.run(argv)
    assert [r.tokens for r in recs] == [r.tokens for r in again]
    assert all(0 <= t < 512 for r in recs for t in r.tokens)
