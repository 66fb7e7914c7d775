"""The decode-attention kernels' plain versions (B5 ``flash_decode``, B6
``flash_decode_paged``) against the JAX package, on the CPU.

Inputs are drawn from a numpy seed and handed to both packages.  Cases:
MHA and GQA (``n_rep`` 2), windows 0, 8 and 64, f32 and bf16 caches, q in
f32 and bf16, page tables that are random permutations of the pool, and a
dead row (every table entry the sentinel ``n_pages``, length 0) that must
equal the JAX gather's clamped read of page ``n_pages - 1``.  The wide-GQA
cases hold the same at hd 128 and ``n_rep`` 7, 8 and 16 (arctic-480b,
deepseek-67b, llama3-405b), with two KV heads, three rows and two pages a
row.

Tolerances, each beside the gap it measured:

* against the reference's XLA forms (``paged_decode_ref``,
  ``_xla_decode``, ``ref.flash_decode_ref``): ``REF_ATOL`` 1e-6 — the same
  ops in the same order, summed by other einsum and softmax
  implementations (measured at most 4.2e-7);
* against the Pallas kernels in interpret mode: 2e-5, the reference's
  own tolerance for its kernel against its XLA form
  (``tests/test_serve.py``; measured at most 3.6e-7 here);
* bf16 outputs (q in bf16): one bf16 ulp of the larger magnitude plus
  ``REF_ATOL`` — both round f32 values that differ by up to that much.

``test_dense_split_merge_matches_pallas`` emulates B5's order of work on
the card (the split of the live keys over a cluster, the online softmax
per 8 keys, the warps' and the blocks' merges) and holds it within 2e-5
of the Pallas kernel in interpret mode.

The wrappers, given CPU tensors, run the plain versions and count a plain
run, never a launch.  (On the card the kernels are held against the same
plain versions by ``chip_smoke.py``.)
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

REF_ATOL = 1e-6
INTERPRET_ATOL = 2e-5
# (n_rep, window)
CASES = [(1, 0), (1, 8), (2, 0), (2, 64)]
DTYPES = [("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16")]
# the wide-GQA forms (the kernels' kRep-8 blocks) at hd 128: n_rep 7
# (arctic-480b, one group of 7 in 8), 8 (deepseek-67b) and 16 (llama3-405b,
# two groups a KV head), two KV heads, a few rows and two pages a row;
# (n_rep, window)
WIDE_CASES = [(7, 0), (8, 16), (16, 0)]
WIDE_PAGED = dict(ns=3, kv=2, hd=128, pp=2, n_pages=8)
WIDE_CONTIG = dict(b=2, kv=2, hd=128, s=32)
WIDE_POS = 29


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bf16" else np.float32


def _t(a):
    return tensor_from_numpy(a, "cpu")


def _paged_inputs(seed, n_rep, q_dt, kv_dt, *, ns=4, kv=2, hd=64,
                  page_len=16, pp=8, n_pages=40):
    """q (ns, kv·n_rep, 1, hd), pages, a scrambled table with row 1 dead
    (all sentinel, length 0) and lengths spread over the table's reach."""
    rng = np.random.default_rng(seed)
    h = kv * n_rep
    q = rng.standard_normal((ns, h, 1, hd)).astype(_np_dtype(q_dt))
    kp = rng.standard_normal((n_pages, page_len, kv, hd)) \
        .astype(_np_dtype(kv_dt))
    vp = rng.standard_normal((n_pages, page_len, kv, hd)) \
        .astype(_np_dtype(kv_dt))
    table = rng.permutation(n_pages)[:ns * pp].reshape(ns, pp) \
        .astype(np.int32)
    lengths = rng.integers(1, pp * page_len, ns).astype(np.int32)
    lengths[0] = pp * page_len - 1
    table[1], lengths[1] = n_pages, 0
    return q, kp, vp, table, lengths


def _contig_inputs(seed, n_rep, q_dt, kv_dt, *, b=2, kv=2, hd=64, s=256):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv * n_rep, 1, hd)).astype(_np_dtype(q_dt))
    k = rng.standard_normal((b, kv, s, hd)).astype(_np_dtype(kv_dt))
    v = rng.standard_normal((b, kv, s, hd)).astype(_np_dtype(kv_dt))
    return q, k, v


def _close(port: torch.Tensor, ref, atol: float):
    """Port output against a JAX output (numpy), elementwise."""
    a = port.float().numpy()
    b = np.asarray(ref).astype(np.float32)
    diff = np.abs(a - b)
    if port.dtype == torch.bfloat16:
        big = np.maximum(np.abs(a), np.abs(b))
        ulp = np.exp2(np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
        return bool((diff <= ulp + atol).all()), float(diff.max())
    return bool((diff <= atol).all()), float(diff.max())


@pytest.mark.parametrize("dts", DTYPES, ids=lambda d: f"q{d[0]}-kv{d[1]}")
@pytest.mark.parametrize("n_rep,window", CASES)
def test_paged_plain_matches_reference(n_rep, window, dts):
    q, kp, vp, table, lengths = _paged_inputs(0, n_rep, *dts)
    args = [jnp.asarray(x) for x in (q, kp, vp, table, lengths)]
    want = jfd.paged_decode_ref(*args, window=window)
    got = fd.paged_decode_ref(*[_t(x) for x in (q, kp, vp, table, lengths)],
                              window=window)
    assert got.dtype == (torch.bfloat16 if dts[0] == "bf16"
                         else torch.float32)
    ok, err = _close(got, want, REF_ATOL)
    assert ok, err


@pytest.mark.parametrize("kv_dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_rep,window", CASES)
def test_paged_wrapper_matches_interpreted_kernel(n_rep, window, kv_dt):
    """B6's wrapper on CPU tensors against the Pallas kernel in interpret
    mode, dead row included (the interpreter clamps the sentinel page
    read as the gather does)."""
    q, kp, vp, table, lengths = _paged_inputs(1, n_rep, "f32", kv_dt)
    want = jfd.flash_decode_paged(*[jnp.asarray(x) for x in
                                    (q, kp, vp, table, lengths)],
                                  window=window, interpret=True)
    fd.reset_counts()
    got = fd.flash_decode_paged(*[_t(x) for x in
                                  (q, kp, vp, table, lengths)],
                                window=window)
    ok, err = _close(got, want, INTERPRET_ATOL)
    assert ok, err
    assert fd.plain_count("flash_decode_paged", kv_dt) == 1
    assert fd.launch_count() == 0


@pytest.mark.parametrize("dts", DTYPES, ids=lambda d: f"q{d[0]}-kv{d[1]}")
@pytest.mark.parametrize("n_rep,window", CASES)
def test_contig_plain_matches_reference(n_rep, window, dts):
    q, k, v = _contig_inputs(2, n_rep, *dts)
    pos = 170
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for want, got in (
            (jfd._xla_decode(jq, jk, jv, pos, window=window),
             fd._xla_decode(_t(q), _t(k), _t(v), pos, window=window)),
            (jref.flash_decode_ref(jq, jk, jv, pos, window=window),
             tref.flash_decode_ref(_t(q), _t(k), _t(v), pos,
                                   window=window))):
        ok, err = _close(got, want, REF_ATOL)
        assert ok, err


@pytest.mark.parametrize("n_rep,window", CASES)
def test_contig_wrapper_matches_interpreted_kernel(n_rep, window):
    q, k, v = _contig_inputs(3, n_rep, "f32", "f32")
    want = jfd.flash_decode(*[jnp.asarray(x) for x in (q, k, v)], 170,
                            window=window, interpret=True)
    fd.reset_counts()
    got = fd.flash_decode(_t(q), _t(k), _t(v), 170, window=window)
    ok, err = _close(got, want, INTERPRET_ATOL)
    assert ok, err
    assert fd.plain_count("flash_decode") == 1 and fd.launch_count() == 0


@pytest.mark.parametrize("dts", DTYPES, ids=lambda d: f"q{d[0]}-kv{d[1]}")
@pytest.mark.parametrize("n_rep,window", WIDE_CASES)
def test_wide_gqa_plain_matches_reference(n_rep, window, dts):
    """B6's and B5's plain versions at the wide configs' group widths and
    hd 128 against the reference's XLA forms and oracle."""
    q, kp, vp, table, lengths = _paged_inputs(7, n_rep, *dts, **WIDE_PAGED)
    want = jfd.paged_decode_ref(*[jnp.asarray(x) for x in
                                  (q, kp, vp, table, lengths)], window=window)
    got = fd.paged_decode_ref(*[_t(x) for x in (q, kp, vp, table, lengths)],
                              window=window)
    ok, err = _close(got, want, REF_ATOL)
    assert ok, err
    q, k, v = _contig_inputs(8, n_rep, *dts, **WIDE_CONTIG)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for want, got in (
            (jfd._xla_decode(jq, jk, jv, WIDE_POS, window=window),
             fd._xla_decode(_t(q), _t(k), _t(v), WIDE_POS, window=window)),
            (jref.flash_decode_ref(jq, jk, jv, WIDE_POS, window=window),
             tref.flash_decode_ref(_t(q), _t(k), _t(v), WIDE_POS,
                                   window=window))):
        ok, err = _close(got, want, REF_ATOL)
        assert ok, err


@pytest.mark.parametrize("kv_dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_rep,window", WIDE_CASES)
def test_wide_gqa_wrappers_match_interpreted_kernels(n_rep, window, kv_dt):
    """B6's and B5's wrappers on CPU tensors at the wide group widths and
    hd 128 against the Pallas kernels in interpret mode (B6's dead row
    included), each a plain run and no launch."""
    q, kp, vp, table, lengths = _paged_inputs(9, n_rep, "f32", kv_dt,
                                              **WIDE_PAGED)
    want = jfd.flash_decode_paged(*[jnp.asarray(x) for x in
                                    (q, kp, vp, table, lengths)],
                                  window=window, interpret=True)
    fd.reset_counts()
    got = fd.flash_decode_paged(*[_t(x) for x in
                                  (q, kp, vp, table, lengths)],
                                window=window)
    ok, err = _close(got, want, INTERPRET_ATOL)
    assert ok, err
    q, k, v = _contig_inputs(10, n_rep, "f32", kv_dt, **WIDE_CONTIG)
    want = jfd.flash_decode(*[jnp.asarray(x) for x in (q, k, v)], WIDE_POS,
                            window=window, interpret=True)
    got = fd.flash_decode(_t(q), _t(k), _t(v), WIDE_POS, window=window)
    ok, err = _close(got, want, INTERPRET_ATOL)
    assert ok, err
    assert fd.plain_count("flash_decode_paged", kv_dt) == 1
    assert fd.plain_count("flash_decode") == 1 and fd.launch_count() == 0


# -- B5's split over a cluster ----------------------------------------------------
def _dense_split_arithmetic(q, k, v, pos, *, window, n_split):
    """The arithmetic of B5's cluster kernel in plain PyTorch, for every row
    and query head at once: the live keys [lo, hi] cut into stages of 8
    keys a warp (8 warps a block, 4 for f32 rows of more than 128 dims)
    and the stages into ``n_split`` contiguous shares (a share may be
    empty); inside a block each warp takes its 8 keys of every stage and
    keeps its own online softmax (m, l, acc) for every query head of its
    KV head's group, updated once per 8 keys; each block merges its warps'
    states, and the leader merges the blocks' (a block alone in its
    cluster writes its own); m = −inf contributes nothing, and a row with
    no key in range gets zeros."""
    b, h, _, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    warps = fd._dense_warps(hd, k.element_size())
    stage = 8 * warps
    n_rep = h // kvh
    hi = min(pos, s - 1)
    lo = max(0, pos - window + 1) if window > 0 else 0
    n_st = -(-(hi - lo + 1) // stage) if hi >= lo else 0
    per = -(-n_st // n_split)
    per_warp = stage // warps
    ninf = -float("inf")
    qf = q[:, :, 0].float() * hd ** -0.5                        # (b, h, hd)
    kf = torch.repeat_interleave(k.float(), n_rep, 1)           # (b, h, s, hd)
    vf = torch.repeat_interleave(v.float(), n_rep, 1)

    def merge(states):
        ms = torch.stack([x[0] for x in states])
        m = ms.amax(0)
        live = m > ninf
        wt = torch.where(live[None], torch.exp(
            ms - torch.where(live, m, 0.0)[None]), 0.0)
        acc = sum(wt[i][..., None] * x[2] for i, x in enumerate(states))
        l = sum(wt[i] * x[1] for i, x in enumerate(states))
        return m, l, acc

    blocks = []
    for rank in range(n_split):
        st0 = min(n_st, rank * per)
        st1 = min(n_st, st0 + per)
        states = []
        for wp in range(warps):
            m = torch.full((b, h), ninf)
            l, acc = torch.zeros(b, h), torch.zeros(b, h, hd)
            for st in range(st0, st1):
                j = lo + st * stage + wp * per_warp + torch.arange(per_warp)
                valid = j <= hi
                jj = j.clamp(max=s - 1)
                sc = torch.einsum("bhd,bhjd->bhj", qf, kf[:, :, jj])
                sc = torch.where(valid, sc, ninf)
                m_new = torch.maximum(m, sc.amax(-1))
                live = m_new > ninf
                safe = torch.where(live, m_new, 0.0)
                p = torch.where(live[..., None],
                                torch.exp(sc - safe[..., None]), 0.0)
                alpha = torch.where(live, torch.exp(m - safe), 1.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhj,bhjd->bhd", p, vf[:, :, jj])
                m = m_new
            states.append((m, l, acc))
        blocks.append(merge(states))
    _, l, acc = blocks[0] if n_split == 1 else merge(blocks)
    out = torch.where(l[..., None] > 0,
                      acc / l[..., None].clamp_min(1e-30), 0.0)
    return out[:, :, None].to(q.dtype)


_PALLAS = {}
B5_SPLIT_S = 80           # 2 or 3 stages: most of 8 shares stay empty


def _pallas_decode(hd, n_rep, window, pos):
    """(inputs, the reference's Pallas kernel in interpret mode) for one
    case, drawn and run once per (hd, n_rep, window, pos)."""
    key = (hd, n_rep, window, pos)
    if key not in _PALLAS:
        q, k, v = _contig_inputs(10 + hd + n_rep, n_rep, "f32", "f32", hd=hd,
                                 s=B5_SPLIT_S)
        want = np.asarray(jfd.flash_decode(
            *map(jnp.asarray, (q, k, v)), pos, window=window,
            interpret=True), np.float32)
        _PALLAS[key] = ((q, k, v), want)
    return _PALLAS[key]


@pytest.mark.parametrize("n_rep", [1, 2, 4])
@pytest.mark.parametrize("hd", [80, 96, 256])
@pytest.mark.parametrize("n_split", [1, 2, 8])
def test_dense_split_merge_matches_pallas(n_split, hd, n_rep):
    """B5's split of the live keys over a cluster, its per-8-keys online
    softmax and the two-level merge, emulated, lie within 2e-5 of the
    Pallas kernel in interpret mode at 1, 2 and 8 blocks a cluster, hd 80
    (zamba2-2.7b), 96 (phi3-mini) and 256 (gemma3-4b), n_rep 1, 2 and 4,
    windows 0 and 16, and positions 0, the middle and the last."""
    for window in (0, 16):
        for pos in (0, B5_SPLIT_S // 2, B5_SPLIT_S - 1):
            (q, k, v), want = _pallas_decode(hd, n_rep, window, pos)
            got = _dense_split_arithmetic(*map(_t, (q, k, v)), pos,
                                          window=window, n_split=n_split)
            ok, err = _close(got, want, INTERPRET_ATOL)
            assert ok, (window, pos, err)


def test_dead_row_reads_the_clamped_page():
    """A dead row (all sentinel, length 0) attends to position 0 of page
    n_pages - 1 alone, in the port's plain version as in JAX's gather."""
    q, kp, vp, table, lengths = _paged_inputs(4, 2, "f32", "f32")
    got = fd.paged_decode_ref(*[_t(x) for x in (q, kp, vp, table, lengths)])
    n_rep = q.shape[1] // kp.shape[2]
    expect = np.repeat(vp[-1, 0], n_rep, axis=0)          # (H, hd)
    np.testing.assert_array_equal(got[1, :, 0].numpy(), expect)
    want = jfd.paged_decode_ref(*[jnp.asarray(x) for x in
                                  (q, kp, vp, table, lengths)])
    np.testing.assert_array_equal(np.asarray(want)[1, :, 0], expect)


def test_paged_equals_contiguous_on_the_same_keys():
    """Scatter contiguous caches into scrambled pages: B6's plain version
    reproduces B5's on each row (the reference's own paged contract)."""
    rng = np.random.default_rng(5)
    ns, h, kv, hd, page_len, pp, n_pages = 3, 4, 2, 64, 16, 4, 16
    q = rng.standard_normal((ns, h, 1, hd)).astype(np.float32)
    k = rng.standard_normal((ns, kv, pp * page_len, hd)).astype(np.float32)
    v = rng.standard_normal((ns, kv, pp * page_len, hd)).astype(np.float32)
    table = rng.permutation(n_pages)[:ns * pp].reshape(ns, pp) \
        .astype(np.int32)
    kp = np.zeros((n_pages, page_len, kv, hd), np.float32)
    vp = np.zeros_like(kp)
    for si in range(ns):
        for pi in range(pp):
            sl = slice(pi * page_len, (pi + 1) * page_len)
            kp[table[si, pi]] = k[si, :, sl].transpose(1, 0, 2)
            vp[table[si, pi]] = v[si, :, sl].transpose(1, 0, 2)
    lengths = np.array([37, 5, 63], np.int32)
    paged = fd.paged_decode_ref(*[_t(x) for x in (q, kp, vp, table, lengths)],
                                window=16)
    for si in range(ns):
        one = fd._xla_decode(_t(q[si:si + 1]), _t(k[si:si + 1]),
                             _t(v[si:si + 1]), int(lengths[si]), window=16)
        torch.testing.assert_close(paged[si:si + 1], one, atol=1e-6,
                                   rtol=1e-6)


def test_wrappers_validate_inputs():
    q, kp, vp, table, lengths = (_t(x) for x in
                                 _paged_inputs(6, 2, "f32", "f32"))
    with pytest.raises(ValueError, match="multiple of 32"):
        fd.flash_decode_paged(q[..., :48], kp[..., :48], vp[..., :48],
                              table, lengths)
    with pytest.raises(ValueError, match="int32"):
        fd.flash_decode_paged(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError, match="differ"):
        fd.flash_decode_paged(q, kp, vp.bfloat16(), table, lengths)
    with pytest.raises(ValueError, match="pos must be"):
        fd.flash_decode(q, kp.permute(0, 2, 1, 3)[:4], vp.permute(0, 2, 1, 3)[:4],
                        -1)
    meta = [t.to("meta") for t in (q, kp, vp, table, lengths)]
    with pytest.raises(ValueError, match="no flash_decode_paged kernel"):
        fd.flash_decode_paged(*meta)


def test_resolve_impl_follows_the_device():
    assert fd.resolve_impl("auto", "cpu") == "plain"
    assert fd.resolve_impl("auto", "cuda") == "cuda"
    assert fd.resolve_impl("plain", "cpu") == "plain"
    with pytest.raises(ValueError):
        fd.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError):
        fd.resolve_impl("plain", "cuda")
