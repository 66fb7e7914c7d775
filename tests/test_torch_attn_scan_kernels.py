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


def _parts(x, n):
    """x as n bf16 parts, each the bf16 rounding of what the ones before
    leave (hi, mid, lo for n = 3)."""
    out = []
    for _ in range(n):
        out.append(x.bfloat16().float())
        x = x - out[-1]
    return out


def _split_mm(a, b, na, nb):
    """a @ b on the tensor cores' terms: each f32 side split into na / nb
    bf16 parts (0: an exact bf16 operand, taken whole), the products of
    part orders i + j <= 2 summed in f32."""
    pa = _parts(a, na) if na else [a]
    pb = _parts(b, nb) if nb else [b]
    return sum(x @ y for i, x in enumerate(pa) for j, y in enumerate(pb)
               if i + j <= 2)


def _wkv_tc_arithmetic(r, k, v, w, u, *, parts=3, q=64, sub=16):
    """The arithmetic of B8's tensor-core form in plain PyTorch, over
    chunks of q = 64 steps (a ragged last chunk padded with zeros) in
    sub-chunks of 16: fp / fq the products of w over a sub-chunk's steps
    before / after each step, T a sub-chunk's whole product;
    y = (r ⊙ fp ⊙ Π_{m<I} T_m)·S + A·v with A's blocks below the diagonal
    (r ⊙ fp ⊙ Π_{J<m<I} T_m)·(k ⊙ fq)ᵀ and its diagonal blocks by running
    products of w in f32 (u on the diagonal); S' = (Π T)·S + (k ⊙ fq ⊙
    Π_{m>J} T_m)ᵀ·v.  Each f32 operand is split into ``parts`` bf16 parts
    (``_split_mm``); r, k and v are exact bf16 values."""
    b, h, s, kd = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()
    state = torch.zeros(b, h, kd, v.shape[-1])
    ns = q // sub
    rows = lambda i: slice(i * sub, (i + 1) * sub)
    ys = []
    for c0 in range(0, s, q):
        n = min(q, s - c0)
        pad = lambda t: torch.nn.functional.pad(t[:, :, c0:c0 + n],
                                                [0, 0, 0, q - n])
        rc, kc, vc, wc = pad(r), pad(k), pad(v), pad(w)
        ws = wc.view(b, h, ns, sub, kd)
        fp, fq = [None] * sub, [None] * sub
        run = torch.ones(b, h, ns, kd)
        for t in range(sub):
            fp[t], run = run, run * ws[:, :, :, t]
        T = run
        run = torch.ones(b, h, ns, kd)
        for t in reversed(range(sub)):
            fq[t], run = run, run * ws[:, :, :, t]
        fp = torch.stack(fp, 3).view(b, h, q, kd)
        fq = torch.stack(fq, 3).view(b, h, q, kd)
        tprod = lambda lo, hi: torch.stack(
            [torch.ones(b, h, kd)] + [T[:, :, m] for m in range(lo, hi)]
        ).prod(0)[:, :, None]
        rb, kq = rc * fp, kc * fq
        y = _split_mm(torch.cat([rb[:, :, rows(i)] * tprod(0, i)
                                 for i in range(ns)], 2), state, parts, parts)
        A = torch.zeros(b, h, q, q)
        for i in range(ns):
            for j in range(i):
                A[:, :, rows(i), rows(j)] = _split_mm(
                    rb[:, :, rows(i)] * tprod(j + 1, i),
                    kq[:, :, rows(j)].transpose(-1, -2), parts, parts)
            ri, ki, wi = rc[:, :, rows(i)], kc[:, :, rows(i)], wc[:, :, rows(i)]
            for sl in range(sub):
                e = torch.ones(b, h, kd)
                A[:, :, i * sub + sl, i * sub + sl] = \
                    (ri[:, :, sl] * u * ki[:, :, sl]).sum(-1)
                for tl in range(sl + 1, sub):
                    A[:, :, i * sub + tl, i * sub + sl] = \
                        (ri[:, :, tl] * ki[:, :, sl] * e).sum(-1)
                    e = e * wi[:, :, tl]
        y = y + _split_mm(A, vc, parts, 0)
        W = torch.cat([kq[:, :, rows(j)] * tprod(j + 1, ns)
                       for j in range(ns)], 2)
        state = state * tprod(0, ns).transpose(-1, -2) \
            + _split_mm(W.transpose(-1, -2), vc, parts, 0)
        ys.append(y[:, :, :n])
    return torch.cat(ys, 2)


def _wkv_model_inputs(b, h, s, kd, vd, decay, seed=0):
    """The model's form of B8's inputs, numpy arrays: r, k, v bf16 values,
    w f32, u f32.  ``decay``: ``"reference"`` the reference tests'
    sigmoid(N)/2 + 1/2; ``"model"`` the RWKV-6 block's own
    ``_ddecay`` = exp(−exp(w0 + lora)) on its init's scales (d_model =
    h·kd, seeded random input); ``"strong"`` exp(−exp(U(−3, ln 46))),
    down to exp(−46) ≈ 1e-20."""
    rng = np.random.default_rng(seed)
    bf = lambda a: a.astype(ml_dtypes.bfloat16)
    r, k = (bf(rng.standard_normal((b, h, s, kd)) * 0.5) for _ in range(2))
    v = bf(rng.standard_normal((b, h, s, vd)) * 0.5)
    if decay == "reference":
        w = 1 / (1 + np.exp(-rng.standard_normal((b, h, s, kd)))) * 0.5 + 0.5
    elif decay == "strong":
        w = np.exp(-np.exp(rng.uniform(-3.0, np.log(46.0), (b, h, s, kd))))
    else:
        from repro_torch.models.rwkv6 import _ddecay
        d = h * kd
        lora = max(16, d // 64)
        p = {"w_lora_a": torch.from_numpy(
                 rng.standard_normal((d, lora)) * d ** -0.5).float(),
             "w_lora_b": torch.from_numpy(
                 rng.standard_normal((lora, d)) * lora ** -0.5).float(),
             "w0": torch.full((d,), -2.0)}
        xw = torch.from_numpy(rng.standard_normal((b, s, d))).float()
        w = _ddecay(p, xw).view(b, s, h, kd).transpose(1, 2).numpy()
    u = rng.standard_normal((h, kd)) * 0.3
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


def _wkv_pallas_f32(r, k, v, w, u):
    """The Pallas kernel (interpret mode) on f32 casts of the inputs: the
    bf16 values of r, k, v are exact in f32, so this is B8's function."""
    f = lambda a: jnp.asarray(np.asarray(a, np.float32))
    s = r.shape[2]
    return torch.from_numpy(np.array(jwkv.wkv6_chunked(
        f(r), f(k), f(v), f(w), f(u), chunk=128 if s % 128 == 0 else s,
        interpret=True), np.float32))


def _f32_limit_ratio(got, want):
    """Worst |got − want| over phase 14's f32 limit 2e-5·(1 + |want|)."""
    return float(((got.float() - want).abs()
                  / (2e-5 * (1 + want.abs()))).max())


# (B, H, S, K, V, decay): the model's K = V = 64 over several chunks, a
# ragged S, K = V = 32 (K padded to 64 on the card), strong decays
WKV_TC_CASES = [(1, 2, 256, 64, 64, "model"), (2, 2, 100, 64, 64, "model"),
                (1, 3, 96, 32, 32, "reference"),
                (1, 2, 128, 64, 64, "strong"), (2, 2, 45, 64, 32, "strong")]


@pytest.mark.parametrize("b,h,s,kd,vd,decay", WKV_TC_CASES)
def test_wkv6_tensor_core_arithmetic_matches_pallas(b, h, s, kd, vd, decay):
    """B8's bf16 form on the model's inputs (bf16 r, k, v; f32 w), emulated
    here, lies within phase 14's f32 limit of the Pallas kernel (interpret
    mode, all f32 inside), strong decays included (measured at most 0.074
    of the limit with three parts)."""
    args = _wkv_model_inputs(b, h, s, kd, vd, decay)
    want = _wkv_pallas_f32(*args)
    got = _wkv_tc_arithmetic(*(torch.from_numpy(np.asarray(a, np.float32))
                               for a in args))
    assert _f32_limit_ratio(got, want) <= 0.2


def test_wkv6_tensor_core_needs_three_parts():
    """Two bf16 parts of each f32 operand break phase 14's f32 limit on the
    model's own decays (measured 1.23x here, 1.41x at S = 100): the kernel
    splits in three."""
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            _wkv_model_inputs(1, 2, 256, 64, 64, "model")]
    want = _wkv_pallas_f32(*args)
    assert _f32_limit_ratio(_wkv_tc_arithmetic(*args, parts=2), want) > 1.0


def test_wkv6_one_level_factorisation_overflows_on_strong_decay():
    """The factorised form (r ⊙ e^c)·(k ⊙ e^−c)ᵀ over a whole chunk of 64,
    c the running sum of log w, overflows once decays are strong; the
    sub-chunked products of w stay finite and within the limit."""
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in
            _wkv_model_inputs(1, 2, 64, 64, 64, "strong")]
    r, k, _, w, _ = args
    c = torch.cumsum(torch.log(w), 2)
    a_one = (r * torch.exp(c - torch.log(w))) @ (k * torch.exp(-c)) \
        .transpose(-1, -2)
    assert not bool(torch.isfinite(torch.tril(a_one, -1)).all())
    got = _wkv_tc_arithmetic(*args)
    assert bool(torch.isfinite(got).all())
    assert _f32_limit_ratio(got, _wkv_pallas_f32(*args)) <= 0.2


def test_wkv6_reads_the_model_views():
    """The wrapper takes what ``time_mix`` hands it — (B, H, S, K) views of
    (B, S, H, K) bf16 r, k, v and f32 w, with ``out_dtype`` f32 — and
    returns the same as on contiguous f32 copies, in f32."""
    b, h, s, kd = 2, 3, 40, 32
    rng = np.random.default_rng(5)
    mk = lambda dt: torch.from_numpy(
        rng.standard_normal((b, s, h, kd)).astype(np.float32) * 0.5).to(dt)
    r, k, v = (mk(torch.bfloat16) for _ in range(3))
    w = torch.sigmoid(mk(torch.float32)) * 0.5 + 0.5
    u = torch.from_numpy(rng.standard_normal((h, kd)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (r, k, v, w)]
    assert not any(t.is_contiguous() for t in views)
    wkv.reset_counts()
    got = wkv.wkv6_chunked(*views, u, out_dtype=torch.float32)
    want = wkv.wkv6_chunked(*(t.float().contiguous() for t in views), u)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, kd)
    assert torch.equal(got, want)
    assert wkv.plain_count() == 2 and wkv.launch_count() == 0


# -- B6's split over a cluster ---------------------------------------------------
def _paged_split_arithmetic(q, kp, vp, table, lengths, *, window, n_split,
                            stage=32, warps=4):
    """The arithmetic of B6's cluster kernel in plain PyTorch: each row's
    live keys [lo, hi] cut into stages of 32 and the stages into
    ``n_split`` contiguous shares (a share may be empty); inside a block
    each of 4 warps takes 8 keys of every stage and keeps its own online
    softmax (m, l, acc); the leader merges every (block, warp) state, m =
    −inf contributing nothing; zeros for a row with no key in range."""
    ns, h, _, hd = q.shape
    n_pages, page_len, kvh = kp.shape[:3]
    n_rep, n_keys = h // kvh, table.shape[1] * page_len
    out = torch.zeros(ns, h, 1, hd)
    per_warp = stage // warps
    for row in range(ns):
        pos = int(lengths[row])
        hi = min(pos, n_keys - 1)
        lo = max(0, pos - window + 1) if window > 0 else 0
        n_st = -(-(hi - lo + 1) // stage) if hi >= lo else 0
        per = -(-n_st // n_split)
        qf = q[row, :, 0].float() * hd ** -0.5                    # (h, hd)
        states = []
        for rank in range(n_split):
            st0 = min(n_st, rank * per)
            st1 = min(n_st, st0 + per)
            for wp in range(warps):
                m = torch.full((h,), -float("inf"))
                l, acc = torch.zeros(h), torch.zeros(h, hd)
                for st in range(st0, st1):
                    j = lo + st * stage + wp * per_warp + torch.arange(
                        per_warp)
                    valid = j <= hi
                    jj = j.clamp(max=hi)
                    page = table[row, jj // page_len].long().clamp(
                        0, n_pages - 1)
                    kk = kp[page, jj % page_len].float()          # (8,kv,hd)
                    vv = vp[page, jj % page_len].float()
                    kk = torch.repeat_interleave(kk, n_rep, 1)    # (8, h, hd)
                    vv = torch.repeat_interleave(vv, n_rep, 1)
                    sc = torch.einsum("hd,jhd->hj", qf, kk)
                    sc = torch.where(valid[None], sc, -float("inf"))
                    m_new = torch.maximum(m, sc.amax(-1))
                    live = m_new > -float("inf")
                    safe = torch.where(live, m_new, 0.0)
                    p = torch.where(live[:, None], torch.exp(
                        sc - safe[:, None]), 0.0)
                    alpha = torch.where(live, torch.exp(m - safe), 1.0)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + torch.einsum(
                        "hj,jhd->hd", p, vv)
                    m = m_new
                states.append((m, l, acc))
        ms = torch.stack([x[0] for x in states])
        m_all = ms.amax(0)
        if n_st == 0:
            continue
        wt = torch.exp(ms - m_all[None])
        num = sum(wt[i][:, None] * x[2] for i, x in enumerate(states))
        den = sum(wt[i] * x[1] for i, x in enumerate(states))
        out[row, :, 0] = num / den[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("n_rep,window", [(1, 0), (2, 8), (2, 0)])
def test_paged_split_merge_matches_pallas(n_split, n_rep, window):
    """B6's split of each row's keys over a cluster and the leader's merge,
    emulated, lie within 2e-5 of the Pallas kernel in interpret mode, at 1,
    2 and 8 blocks a cluster; the short rows leave most of the 8 shares
    empty, and the dead row (all sentinel ids, length 0) reads page P − 1
    as the reference's gather does."""
    rng = np.random.default_rng(11)
    ns, kvh, hd, page_len, pp, n_pages = 4, 2, 64, 16, 8, 40
    h = kvh * n_rep
    q = rng.standard_normal((ns, h, 1, hd)).astype(np.float32)
    kp = rng.standard_normal((n_pages, page_len, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page_len, kvh, hd)).astype(np.float32)
    table = rng.permutation(n_pages)[:ns * pp].reshape(ns, pp) \
        .astype(np.int32)
    table[1] = n_pages
    lengths = np.array([127, 0, 40, 5], np.int32)
    want = np.asarray(jfd.flash_decode_paged(
        *map(jnp.asarray, (q, kp, vp, table, lengths)), window=window,
        interpret=True), np.float32)
    got = _paged_split_arithmetic(*map(_t, (q, kp, vp, table, lengths)),
                                  window=window, n_split=n_split)
    _close(got, want, TOL["f32"])


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
    # the per-leaf form (mesh-sharded trees, ROADMAP A11): one B2 run per
    # leaf, these leaves through the padded store layout.  It updates its
    # params in place, so it gets copies: ``conv`` shares the numpy
    # buffers, which the reference's (asynchronous) run may still read
    want = jops.dbl_merge(*(jax.tree_util.tree_map(
        jnp.asarray, t) for t in (p, gl, gs)), factor=0.81, lr=0.05,
        interpret=True, leafwise=True)
    mine = {"a": p["a"].copy(), "b": [p["b"][0].copy()]}
    got = ops.dbl_merge(conv(mine), conv(gl), conv(gs), factor=0.81,
                        lr=0.05, leafwise=True)
    _close(got["a"], want["a"], 1e-6)
    _close(got["b"][0], want["b"][0], 1e-6)


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
    refused (the message names the differentiable training form), never
    run through the plain version."""
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
    with pytest.raises(RuntimeError, match="no backward.*train=True"):
        calls[name]()
