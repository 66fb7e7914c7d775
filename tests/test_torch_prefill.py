"""The port's LM prefill forward (``models.forward``,
``launch.steps.make_prefill_step``) against the JAX package's, on the CPU.

Reduced f32 configs, each with the reference's ``init_params`` carried
over through ``convert.lm_params_from_numpy`` and the same numpy tokens:
``zamba2-2.7b`` at 6 layers (``[('mamba2', 5), ('shared_attn', 1)]``, so
that the weight-tied shared block runs; at the default 2 layers it has
none), ``rwkv6-7b``, ``gemma3-4b`` (sliding window 16) and
``phi3-mini-3.8b``, at S = 45: not a multiple of the SSD chunk (32, which
``ssd_chunked`` shrinks to 15) nor of anything else.

``BAND`` 1e-4 on the logits (magnitude about 4): the two packages run the
same scans in f32 with other matmul and reduction orders (measured
8.7e-6 zamba2, 8.8e-6 rwkv6, 5.2e-6 gemma3, 5.2e-6 phi3).  Two planted
faults — the WKV bonus ``u`` dropped, the SSD state reset at every chunk —
land far outside it.  On the CPU the forward runs the ports of the
reference's scans, so no kernel wrapper counts a run; on the card it runs
B4 / B7 / B8 (``chip_smoke.py`` phases 15-16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro_torch import models
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy, params_to_numpy
from repro_torch.core.tree import tree_flatten, tree_leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ssd
from repro_torch.kernels import wkv6 as wkv
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import attention, mamba2, rwkv6, transformer

torch.set_num_threads(1)

BAND = 1e-4
SEQ = 45
ARCHS = [("zamba2-2.7b", 6), ("rwkv6-7b", 2), ("gemma3-4b", 2),
         ("phi3-mini-3.8b", 2)]
_CACHE = {}


def _setup(arch, layers):
    """(port cfg, JAX cfg, JAX params, port params, tokens, JAX logits)."""
    key = (arch, layers)
    if key not in _CACHE:
        jcfg = jreduced(jget_config(arch), layers=layers)
        cfg = reduced(get_config(arch), layers=layers)
        jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, "cpu")
        tok = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
        want = np.asarray(jmodels.forward(jp, jcfg, jnp.asarray(tok)))
        _CACHE[key] = (cfg, jcfg, jp, tp, tok, want)
    return _CACHE[key]


def _gap(got, want):
    return float(np.abs(got.detach().float().numpy() - want).max())


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_forward_matches_reference(arch, layers):
    cfg, _, _, tp, tok, want = _setup(arch, layers)
    for mod in (fa, ssd, wkv):
        mod.reset_counts()
    got = models.forward(tp, cfg, torch.from_numpy(tok).long())
    assert got.shape == want.shape == (2, SEQ, cfg.vocab_size)
    assert _gap(got, want) <= BAND
    # the CPU runs the ports of the reference's scans, no kernel wrapper
    assert sum(m.launch_count() + m.plain_count() for m in (fa, ssd, wkv)) == 0


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_prefill_step_matches_reference(arch, layers):
    cfg, jcfg, jp, tp, tok, want = _setup(arch, layers)
    got = make_prefill_step(cfg)(tp, torch.from_numpy(tok).long())
    ref = np.asarray(jmake_prefill_step(jcfg)(jp, jnp.asarray(tok)))
    assert got.shape == ref.shape == (2, cfg.vocab_size)
    assert _gap(got, ref) <= BAND
    assert _gap(got, want[:, -1]) <= BAND
    assert torch.is_inference(got)


def test_forward_options():
    """``embeddings`` stands in for the token embedding, ``positions`` for
    the default ``arange``, ``return_hidden`` stops before the head."""
    cfg, jcfg, jp, tp, tok, want = _setup("zamba2-2.7b", 6)
    tt = torch.from_numpy(tok).long()
    emb = tp["embed"][tt]
    np.testing.assert_array_equal(
        models.forward(tp, cfg, None, embeddings=emb).numpy(),
        models.forward(tp, cfg, tt).numpy())
    pos = torch.arange(SEQ).expand(2, SEQ) + 3
    jpos = jnp.broadcast_to(jnp.arange(SEQ) + 3, (2, SEQ))
    got = models.forward(tp, cfg, tt, positions=pos, last_only=True)
    ref = np.asarray(jmodels.forward(jp, jcfg, jnp.asarray(tok),
                                     positions=jpos, last_only=True))
    assert got.shape == (2, 1, cfg.vocab_size) and _gap(got, ref) <= BAND
    hid = models.forward(tp, cfg, tt, return_hidden=True)
    jhid = np.asarray(jmodels.forward(jp, jcfg, jnp.asarray(tok),
                                      return_hidden=True))
    assert hid.shape == (2, SEQ, cfg.d_model) and _gap(hid, jhid) <= BAND


def _drop_u(orig):
    def scan(r, k, v, w, u, state=None):
        return orig(r, k, v, w, torch.zeros_like(u), state)
    return scan


def _reset_per_chunk(orig):
    def chunked(x, dt, A_log, B, C, D_skip, *, chunk, h0=None):
        ys = [orig(x[:, i:i + chunk], dt[:, i:i + chunk], A_log,
                   B[:, i:i + chunk], C[:, i:i + chunk], D_skip,
                   chunk=chunk)[0] for i in range(0, x.shape[1], chunk)]
        return torch.cat(ys, dim=1), None
    return chunked


@pytest.mark.parametrize("fault", ["u_dropped", "ssd_state_reset"])
def test_planted_fault_breaks_the_band(monkeypatch, fault):
    if fault == "u_dropped":
        arch, layers = "rwkv6-7b", 2
        monkeypatch.setattr(rwkv6, "wkv6_scan", _drop_u(rwkv6.wkv6_scan))
    else:
        arch, layers = "zamba2-2.7b", 6
        monkeypatch.setattr(mamba2, "ssd_chunked",
                            _reset_per_chunk(mamba2.ssd_chunked))
    cfg, _, _, tp, tok, want = _setup(arch, layers)
    gap = _gap(models.forward(tp, cfg, torch.from_numpy(tok).long()), want)
    assert gap > 10 * BAND, gap


def _paths(tree):
    """[(key path, shape, dtype name)] of a dict/list tree, in
    ``jax.tree_util``'s order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, c in enumerate(t):
                walk(c, path + (i,))
        else:
            dt = str(t.dtype).replace("torch.", "")
            out.append((path, tuple(t.shape), dt))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch,layers", ARCHS)
def test_init_tree_matches_reference(arch, layers):
    """The port's ``init_params`` draws the reference's tree: key path for
    key path, the same shapes and dtypes, and the same structure — for
    zamba2 the shared block under ``"shared"`` (an attention block) and an
    empty ``{}`` for each of its calls among the segments."""
    cfg, jcfg, jp, _, _, _ = _setup(arch, layers)
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    ref = jax.tree_util.tree_map(np.asarray, jp)
    assert _paths(tp) == _paths(ref)
    assert tree_flatten(tp)[1] == tree_flatten(ref)[1]
    if arch == "zamba2-2.7b":
        assert [s.kind for s in transformer.layout(cfg)] == ["mamba2",
                                                              "shared_attn"]
        assert tp["segments"][1] == {} and set(tp["shared"]) == {
            "ln1", "attn", "ln2", "mlp"}


def test_bf16_init_dtypes_match_reference():
    """At the published dtypes (bf16 weights, f32 norms and SSM constants)
    on a narrow zamba2: the same dtype at every key path."""
    from dataclasses import replace
    jcfg = replace(jreduced(jget_config("zamba2-2.7b"), layers=6),
                   param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = replace(reduced(get_config("zamba2-2.7b"), layers=6),
                  param_dtype="bfloat16", compute_dtype="bfloat16")
    ref = jax.eval_shape(lambda: jmodels.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert _paths(tp) == [(p, s, str(d)) for p, s, d in _paths(ref)]


def test_convert_round_trip_and_checks():
    cfg, _, jp, tp, _, _ = _setup("zamba2-2.7b", 6)
    back = params_to_numpy(tp)
    ref = jax.tree_util.tree_map(np.asarray, jp)
    assert tree_flatten(back)[1] == tree_flatten(ref)[1]
    for a, b in zip(tree_leaves(back), tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    bad = dict(ref, segments=[ref["segments"][0], {"ln1": np.zeros(3)}])
    with pytest.raises(ValueError, match="belong under 'shared'"):
        lm_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="lacks a 'shared' block"):
        lm_params_from_numpy({k: v for k, v in ref.items() if k != "shared"},
                             cfg, "cpu")


def test_unported_paths_name_their_items():
    from dataclasses import replace

    from repro_torch.configs.base import MoEConfig
    cfg = reduced(get_config("phi3-mini-3.8b"))
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    # the dense LM loss is ported (tests/test_torch_lm_train.py); an MoE
    # model's still names its item
    moe = replace(cfg, moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64))
    tok = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A12"):
        models.loss_fn(tp, moe, {"tokens": tok, "labels": tok})
    enc = replace(cfg, encoder_layers=2)
    with pytest.raises(NotImplementedError, match="A12"):
        models.init_params(enc, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        make_prefill_step(enc)


def test_wkv6_scan_from_a_state_matches_reference():
    """The CPU scan from a given state (the decode slice's entry) against
    the reference's, f32 within 2e-5, final state included."""
    from repro.models import rwkv6 as jrwkv6
    rng = np.random.default_rng(3)
    b, s, h, kd = 2, 13, 3, 8
    r, k, v = (rng.normal(size=(b, s, h, kd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.5 + 0.5 / (1 + np.exp(-rng.normal(size=(b, s, h, kd))))) \
        .astype(np.float32)
    u = rng.normal(size=(h, kd)).astype(np.float32) * 0.3
    st = rng.normal(size=(b, h, kd, kd)).astype(np.float32)
    jy, jst = jrwkv6.wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                               jnp.asarray(st), chunk=4)
    y, fst = rwkv6.wkv6_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                             torch.from_numpy(st))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(fst.numpy(), np.asarray(jst), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention_with_offset_matches_reference(window):
    """Causal attention behind a cache (q_offset > 0, sq < sk) runs the
    port of the reference's scan on the CPU; f32 within 2e-5."""
    from repro.models import attention as jattention
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 21, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = jattention.chunked_attention(
        *(jnp.asarray(a) for a in (q, k, v)), window=window, block_k=8,
        q_offset=16, causal_skip=False)
    got = attention.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), window=window,
        block_k=8, q_offset=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_stateful_paths_refused_off_the_cpu():
    """Off the CPU a WKV state to start from and causal attention with a
    query offset raise, naming their items, rather than running the
    eager scans on the card (meta tensors stand in for CUDA ones here)."""
    cfg = reduced(get_config("rwkv6-7b"))
    x = torch.empty(1, 4, cfg.d_model, device="meta")
    state = torch.empty(1, cfg.n_heads, cfg.head_dim, cfg.head_dim,
                        device="meta")
    with pytest.raises(NotImplementedError, match="A14"):
        rwkv6.time_mix({}, x, cfg, wkv_state=state)
    q = torch.empty(1, 2, 4, 16, device="meta")
    kv = torch.empty(1, 6, 2, 16, device="meta")
    with pytest.raises(NotImplementedError, match="A12"):
        attention.chunked_attention(q, kv, kv, q_offset=4)
    q6 = torch.empty(1, 6, 4, 16, device="meta")
    with pytest.raises(NotImplementedError, match="A12"):
        attention.chunked_attention(q6, kv, kv, q_offset=2)
