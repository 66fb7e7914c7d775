"""The prefill kernels' plain versions (B4 ``flash_attention``, B7
``mamba_ssd_scan``, B8 ``wkv6_chunked``) and the port's ``kernels/ops.py``
front ends against the JAX package's Pallas kernels in interpret mode, on
the CPU.

Inputs are drawn from a numpy seed (the reference tests' distributions)
and handed to both packages.  Shapes: the sweep of
``tests/test_kernels.py``, plus head dim 80 (zamba2's attention), a
ragged S (45 and 100, where the Pallas kernel takes the whole sequence as
one block) and, for the SSD scan, a chunk that the reference's XLA scan
must shrink (32 at S = 45: ``ssd_chunked`` runs chunks of 15, the Pallas
kernel cannot take it).

Tolerances, the reference tests' own (``assert_allclose`` with atol =
rtol): 2e-5 in f32 and 2e-2 in bf16, times 5 for the SSD scan, whose
chunked and per-step forms sum in other orders (the port's plain
versions are the per-step oracles; the Pallas kernels the chunked
forms).  Measured here at most 2.2e-6 (B4), 1.0e-6 (B7) and 2.4e-6 (B8)
in f32.

B4's bf16 form on the card computes S from the bf16 operands in f32 and
P·V with P split into two bf16 parts (tensor-core ``wgmma``); B7's bf16
form runs the chunked SSD with each f32 factor (decay, dt, the state)
folded onto one side of a product and split the same way.  Both, emulated
in plain PyTorch, are held against the Pallas kernels within
``chip_smoke.py``'s bf16 limit (2e-5·(1 + |ref|), x5 for B7, plus one bf16
ulp), and rounding those operands to bf16 once is shown to break it.

The wrappers, given CPU tensors, run their plain versions and count a
plain run, never a launch; they refuse other devices.  On the card
``chip_smoke.py`` (phase 14) holds the kernels to the same plain versions
at the model geometries, and ``tests/test_torch_cuda.py`` at small shapes.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.kernels import mamba_scan as jssd
from repro.kernels import ops as jops
from repro.kernels import wkv6 as jwkv
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as fa_ref
from repro_torch.kernels import mamba_scan as ssd
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2e-2}
SSD_SCALE = 5


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bf16" else np.float32


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _close(got, want, tol):
    got = np.asarray(tensor_to_numpy(got.float()) if isinstance(
        got, torch.Tensor) else got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -- B4 -------------------------------------------------------------------------
FA_CASES = [(2, 4, 2, 256, 64), (1, 4, 4, 128, 32), (2, 8, 1, 256, 128),
            (1, 2, 2, 512, 64), (1, 4, 2, 100, 80), (2, 4, 2, 45, 64)]


def _fa_inputs(b, h, kv, s, hd, dt, seed=0, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.standard_normal((b, h, s, hd)).astype(_np_dtype(dt)),
            rng.standard_normal((b, kv, sk, hd)).astype(_np_dtype(dt)),
            rng.standard_normal((b, kv, sk, hd)).astype(_np_dtype(dt)))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("b,h,kv,s,hd", FA_CASES)
def test_flash_attention_matches_pallas(b, h, kv, s, hd, window, dt):
    q, k, v = _fa_inputs(b, h, kv, s, hd, dt)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, window=window, interpret=True)
    fa.reset_counts()
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=window)
    assert got.dtype == _t(q).dtype and got.shape == (b, h, s, hd)
    _close(got, want, TOL[dt])
    _close(fa.flash_attention_plain(_t(q), _t(k), _t(v), window=window),
           want, TOL[dt])
    assert fa.plain_count("flash_attention", dt) == 1
    assert fa.launch_count() == 0


@pytest.mark.parametrize("sk", [128, 77])
def test_flash_attention_noncausal(sk):
    q, k, v = _fa_inputs(1, 2, 2, 128, 64, "f32", seed=1, sk=sk)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    if sk % 128 == 0:
        want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   interpret=True)
    else:                  # the Pallas kernel asks for whole blocks of keys
        from repro.kernels.ref import flash_attention_ref
        want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False)
    _close(got, want, TOL["f32"])


def _wgmma_arithmetic(q, k, v, *, causal=True, window=0, split=True):
    """The arithmetic of B4's bf16 tensor-core form in plain PyTorch: S from
    the bf16 operands in f32 (each product exact), times hd^-0.5 after;
    an online softmax over key tiles of 128 (64 at hd 256); P·V with P in
    f32 split into bf16(P) + bf16(P − bf16(P)) — or, with ``split=False``,
    rounded to bf16 once; the output rounded once to bf16."""
    b, h, sq, hd = q.shape
    sk, n_rep = k.shape[2], h // k.shape[1]
    kf = torch.repeat_interleave(k.float(), n_rep, dim=1)
    vf = torch.repeat_interleave(v.float(), n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * hd ** -0.5
    if causal:
        i = torch.arange(sq)[:, None]
        j = torch.arange(sk)[None, :]
        keep = j <= i
        if window > 0:
            keep = keep & (i - j < window)
        s = torch.where(keep, s, fa_ref.NEG_INF)
    bk = 64 if hd > 128 else 128
    m = torch.full((b, h, sq, 1), fa_ref.NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, hd)
    for k0 in range(0, sk, bk):
        st = s[..., k0:k0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        acc = acc * alpha
        for part in parts:
            acc = acc + part @ vf[..., k0:k0 + bk, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _bf16_limit_ratio(got, want, scale=1.0):
    """Worst |got − want| over phase 14's bf16 limit: 2e-5·scale·(1 +
    |want|) plus one bf16 ulp of the larger magnitude."""
    g, w = got.float(), want.float()
    a = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    limit = 2e-5 * scale * (1 + w.abs()) \
        + torch.exp2(torch.floor(torch.log2(a)) - 7)
    return float(((g - w).abs() / limit).max())


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("b,h,kv,s,hd", FA_CASES)
def test_tensor_core_arithmetic_matches_pallas(b, h, kv, s, hd, window):
    """B4's bf16 form computes S from bf16 operands and P·V with P split
    in two bf16 parts: emulated here, it lies within phase 14's bf16 limit
    of the Pallas kernel (interpret mode, all f32 inside); rounding P to
    bf16 once instead breaks that limit."""
    q, k, v = _fa_inputs(b, h, kv, s, hd, "bf16")
    want = torch.from_numpy(np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, interpret=True), np.float32))
    args = (_t(q), _t(k), _t(v))
    assert _bf16_limit_ratio(_wgmma_arithmetic(*args, window=window),
                             want) <= 1.0
    assert _bf16_limit_ratio(_wgmma_arithmetic(*args, window=window,
                                               split=False), want) > 1.0


# -- B7 -------------------------------------------------------------------------
SSD_CASES = [(2, 3, 256, 64, 16, 64), (1, 2, 128, 32, 64, 128),
             (2, 1, 192, 64, 32, 48), (1, 4, 64, 128, 8, 16),
             (2, 16, 45, 32, 16, 45)]


def _ssd_inputs(bt, h, s, p, n, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, h, s, p)).astype(_np_dtype(dt))
    dtv = (np.abs(rng.standard_normal((bt, h, s))) * 0.1 + 0.01) \
        .astype(np.float32)
    a_log = np.log(np.linspace(1, 8, h)).astype(np.float32)
    B = (rng.standard_normal((bt, s, n)) * 0.3).astype(_np_dtype(dt))
    C = (rng.standard_normal((bt, s, n)) * 0.3).astype(_np_dtype(dt))
    return x, dtv, a_log, B, C, np.ones(h, np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("bt,h,s,p,n,chunk", SSD_CASES)
def test_mamba_ssd_matches_pallas(bt, h, s, p, n, chunk, dt):
    args = _ssd_inputs(bt, h, s, p, n, dt)
    want = jssd.mamba_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                               interpret=True)
    ssd.reset_counts()
    got = ops.mamba_ssd(*map(_t, args), chunk=chunk)
    assert got.dtype == _t(args[0]).dtype and got.shape == (bt, h, s, p)
    _close(got, want, SSD_SCALE * TOL[dt])
    assert ssd.plain_count("mamba_ssd_scan", dt) == 1
    assert ssd.launch_count() == 0


def _ssd_wgmma_arithmetic(x, dt, A_log, B, C, D_skip, *, split=True, q=64):
    """The arithmetic of B7's bf16 tensor-core form in plain PyTorch, over
    chunks of q = 64 steps (a ragged last chunk padded with zero rows):
    cum the running sum of dt·a in the chunk; C·Bᵀ from the bf16 operands
    in f32 (each product exact); the decay exp(cum_i − cum_j) selected for
    j ≤ i, times C·Bᵀ and dt_j, split into bf16(M) + bf16(M − bf16(M)) and
    multiplied into bf16 x; C times the f32 state's two bf16 parts, times
    exp(cum_i); the state times exp(cum_Q) plus xᵀ times the two parts of B
    ⊙ dt_j·exp(cum_Q − cum_j); + D·x, rounded once to bf16.  With
    ``split=False`` each f32 operand is rounded to bf16 once instead."""
    bt, h, s, p = x.shape
    bf = lambda v: v.bfloat16().float()
    parts = (lambda v: (bf(v), bf(v - bf(v)))) if split else (
        lambda v: (bf(v),))
    a = -torch.exp(A_log.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros(bt, h, p, B.shape[-1])
    keep = torch.arange(q)[:, None] >= torch.arange(q)[None, :]
    ys = []
    for c0 in range(0, s, q):
        n = min(q, s - c0)
        pad = lambda t, dim: torch.nn.functional.pad(
            t[(slice(None),) * dim + (slice(c0, c0 + n),)],
            [0, 0] * (t.dim() - 1 - dim) + [0, q - n])
        xc, dc = pad(xf, 2), pad(dtf, 2)                # (bt,h,q,p), (bt,h,q)
        Bc, Cc = pad(Bf, 1), pad(Cf, 1)                 # (bt,q,N)
        cum = torch.cumsum(dc * a[None, :, None], -1)   # (bt,h,q)
        diff = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
        cb = (Cc @ Bc.transpose(1, 2))[:, None]         # (bt,1,q,q)
        m = torch.where(keep, cb * torch.exp(diff) * dc[..., None, :], 0.0)
        y = sum(Cc[:, None] @ part.transpose(-1, -2) for part in parts(state))
        y = y * torch.exp(cum)[..., None]
        for part in parts(m):
            y = y + part @ xc
        w = Bc[:, None] * (dc * torch.exp(cum[..., -1:] - cum))[..., None]
        state = state * torch.exp(cum[..., -1])[..., None, None]
        for part in parts(w):
            state = state + xc.transpose(-1, -2) @ part
        ys.append((y + xc * D_skip.float()[None, :, None, None])[:, :, :n])
    return torch.cat(ys, 2).to(x.dtype)


@pytest.mark.parametrize("bt,h,s,p,n,chunk", SSD_CASES)
def test_ssd_tensor_core_arithmetic_matches_pallas(bt, h, s, p, n, chunk):
    """B7's bf16 form, emulated here, lies within phase 14's bf16 limit of
    the Pallas kernel (interpret mode, all f32 inside) with the SSD scale of
    5; rounding each f32 operand to bf16 once instead breaks that limit
    (measured 2.1-13x it at these cases)."""
    args = _ssd_inputs(bt, h, s, p, n, "bf16")
    want = torch.from_numpy(np.asarray(jssd.mamba_ssd_scan(
        *map(jnp.asarray, args), chunk=chunk, interpret=True), np.float32))
    ts = [_t(a) for a in args]
    assert _bf16_limit_ratio(_ssd_wgmma_arithmetic(*ts), want,
                             SSD_SCALE) <= 1.0
    assert _bf16_limit_ratio(_ssd_wgmma_arithmetic(*ts, split=False), want,
                             SSD_SCALE) > 1.0


def test_mamba_ssd_where_the_chunk_must_shrink():
    """S = 45 with chunk 32: the reference's XLA scan shrinks its chunk to
    15; the port's kernel and plain version take any S."""
    x, dtv, a_log, B, C, D = _ssd_inputs(2, 4, 45, 32, 16, "f32", seed=3)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    want, _ = jssd_chunked(tr(x), jnp.asarray(dtv).transpose(0, 2, 1),
                           jnp.asarray(a_log), jnp.asarray(B), jnp.asarray(C),
                           jnp.asarray(D), chunk=32)
    got = ops.mamba_ssd(*map(_t, (x, dtv, a_log, B, C, D)), chunk=32)
    _close(got, np.asarray(want).transpose(0, 2, 1, 3), SSD_SCALE * TOL["f32"])


# -- B8 -------------------------------------------------------------------------
WKV_CASES = [(2, 2, 128, 32, 32, 32, "f32"), (1, 3, 96, 64, 64, 48, "f32"),
             (1, 1, 64, 128, 64, 64, "f32"), (2, 4, 45, 64, 64, 128, "f32"),
             (1, 3, 96, 64, 64, 48, "bf16")]


def _wkv_inputs(b, h, s, kd, vd, dt, seed=0):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, h, s, kd)) * 0.5).astype(_np_dtype(dt))
    k = (rng.standard_normal((b, h, s, kd)) * 0.5).astype(_np_dtype(dt))
    v = (rng.standard_normal((b, h, s, vd)) * 0.5).astype(_np_dtype(dt))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, h, s, kd)))) * 0.5
         + 0.5).astype(_np_dtype(dt))
    u = (rng.standard_normal((h, kd)) * 0.3).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("b,h,s,kd,vd,chunk,dt", WKV_CASES)
def test_wkv6_matches_pallas(b, h, s, kd, vd, chunk, dt):
    args = _wkv_inputs(b, h, s, kd, vd, dt)
    want = jwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk,
                             interpret=True)
    wkv.reset_counts()
    got = ops.wkv6(*map(_t, args), chunk=chunk)
    assert got.dtype == _t(args[0]).dtype and got.shape == (b, h, s, vd)
    _close(got, want, TOL[dt])
    assert wkv.plain_count("wkv6_chunked", dt) == 1
    assert wkv.launch_count() == 0


# -- the other front ends and the rules of ops ----------------------------------
def test_ops_flash_decode_matches_pallas():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 1, 64)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    want = jfd.flash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            200, window=64, interpret=True)
    got = ops.flash_decode(_t(q), _t(kc), _t(vc), 200, window=64,
                           backend="plain")
    _close(got, want, TOL["f32"])


def test_ops_dbl_merge_matches_pallas():
    rng = np.random.default_rng(5)
    tree = lambda: {"a": rng.standard_normal((3, 70)).astype(np.float32),
                    "b": [rng.standard_normal(300).astype(np.float32)]}
    p, gl, gs = tree(), tree(), tree()
    want = jops.dbl_merge(*(jax.tree_util.tree_map(
        jnp.asarray, t) for t in (p, gl, gs)), factor=0.81, lr=0.05,
        interpret=True, leafwise=False)
    conv = lambda t: {"a": _t(t["a"]), "b": [_t(t["b"][0])]}
    got = ops.dbl_merge(conv(p), conv(gl), conv(gs), factor=0.81, lr=0.05)
    _close(got["a"], want["a"], 1e-6)
    _close(got["b"][0], want["b"][0], 1e-6)
    with pytest.raises(NotImplementedError, match="A11"):
        ops.dbl_merge(conv(p), conv(gl), conv(gs), factor=0.81, lr=0.05,
                      leafwise=True)


@pytest.mark.parametrize("backend,ok", [("auto", True), ("plain", True),
                                        ("cuda", False), ("pallas", False)])
def test_ops_backend_rule_on_cpu(backend, ok):
    r, k, v, w, u = map(_t, _wkv_inputs(1, 1, 8, 32, 32, "f32"))
    if ok:
        assert ops.wkv6(r, k, v, w, u, backend=backend).shape == v.shape
    else:
        with pytest.raises(ValueError, match="cannot run"):
            ops.wkv6(r, k, v, w, u, backend=backend)


def _meta_calls():
    m = lambda *s: torch.zeros(*s, device="meta")
    return {
        "flash_attention": lambda: fa.flash_attention(
            m(1, 2, 8, 64), m(1, 2, 8, 64), m(1, 2, 8, 64)),
        "mamba_ssd_scan": lambda: ssd.mamba_ssd_scan(
            m(1, 2, 8, 32), m(1, 2, 8), m(2), m(1, 8, 16), m(1, 8, 16), m(2)),
        "wkv6_chunked": lambda: wkv.wkv6_chunked(
            m(1, 2, 8, 32), m(1, 2, 8, 32), m(1, 2, 8, 32), m(1, 2, 8, 32),
            m(2, 32)),
    }


@pytest.mark.parametrize("name", list(_meta_calls()))
def test_wrappers_refuse_other_devices(name):
    with pytest.raises(ValueError, match=f"no {name} kernel for meta"):
        _meta_calls()[name]()


def test_wrappers_check_shapes_and_dtypes():
    q = torch.zeros(1, 3, 8, 64)
    with pytest.raises(ValueError, match="query heads"):
        fa.flash_attention(q, torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(torch.zeros(1, 2, 8, 64), torch.zeros(
            1, 2, 8, 64, dtype=torch.bfloat16), torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="want dt"):
        ssd.mamba_ssd_scan(torch.zeros(1, 2, 8, 32), torch.zeros(1, 8, 2),
                           torch.zeros(2), torch.zeros(1, 8, 16),
                           torch.zeros(1, 8, 16), torch.zeros(2))
    with pytest.raises(ValueError, match="u must be"):
        wkv.wkv6_chunked(*(torch.zeros(1, 2, 8, 32),) * 4, torch.zeros(3, 32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "mamba_ssd_scan",
                                  "wkv6_chunked"])
def test_wrappers_refuse_grad_on_cuda(cuda, name):
    """The kernels have no backward: a CUDA input that requires grad is
    refused (naming ROADMAP A12), never run through the plain version."""
    g = lambda *s: torch.randn(*s, device=cuda, requires_grad=True)
    z = lambda *s: torch.randn(*s, device=cuda)
    calls = {
        "flash_attention": lambda: fa.flash_attention(
            g(1, 2, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64)),
        "mamba_ssd_scan": lambda: ssd.mamba_ssd_scan(
            g(1, 2, 8, 32), z(1, 2, 8).abs(), z(2), z(1, 8, 16), z(1, 8, 16),
            z(2)),
        "wkv6_chunked": lambda: wkv.wkv6_chunked(
            g(1, 2, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32),
            z(2, 32)),
    }
    with pytest.raises(RuntimeError, match="A12"):
        calls[name]()
