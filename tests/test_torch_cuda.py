"""The engine's device fences on the card: the default device is CUDA, TF32
is off, and parameters that live elsewhere are refused.  (``chip_smoke.py``
holds every kernel variant bit-equal to its plain version on the card.)
Skips without a GPU; on one, run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed)."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device fences are tested "
                    "without one in test_torch_imports.py)")
    return torch.device("cuda")


def test_engine_refuses_params_off_its_device(cuda):
    from dataclasses import replace

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.engine import TrainEngine
    from repro_torch.optim import sgd_momentum
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    engine = TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True)
    assert engine.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    on_card = models.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(t.device == engine.device for t in
               [on_card["stem"], on_card["fc_w"], on_card["bn0"]["scale"]])
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="live on cpu"):
        engine.run([], params, None, lambda ph, g: {})


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_match_plain_versions(cuda, kv_dtype):
    """B5 and B6 on the card against their plain versions at a small GQA
    shape with a window and a dead row, f32 q (within 2e-5: the two sum
    the softmax in other orders; chip_smoke.py holds them at the serving
    shapes)."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, h, kv, hd, page_len, pp, n_pages = 4, 4, 2, 64, 16, 4, 20
    q = torch.randn(rows, h, 1, hd, generator=gen, device=cuda)
    kp = torch.randn(n_pages, page_len, kv, hd, generator=gen,
                     device=cuda).to(kv_dtype)
    vp = torch.randn(n_pages, page_len, kv, hd, generator=gen,
                     device=cuda).to(kv_dtype)
    table = torch.randperm(n_pages, generator=gen, device=cuda)[
        :rows * pp].reshape(rows, pp).int()
    table[1] = n_pages                                   # dead row
    lengths = torch.tensor([63, 0, 17, 40], dtype=torch.int32, device=cuda)
    fd.reset_counts()
    for w in (0, 8):
        got = fd.flash_decode_paged(q, kp, vp, table, lengths, window=w)
        want = fd.paged_decode_ref(q, kp, vp, table, lengths, window=w)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        kc = kp[table.long().clamp(0, n_pages - 1)].reshape(
            rows, pp * page_len, kv, hd).transpose(1, 2).contiguous()
        vc = vp[table.long().clamp(0, n_pages - 1)].reshape(
            rows, pp * page_len, kv, hd).transpose(1, 2).contiguous()
        got = fd.flash_decode(q, kc, vc, 50, window=w)
        torch.testing.assert_close(got, fd._xla_decode(q, kc, vc, 50,
                                                       window=w),
                                   atol=2e-5, rtol=0)
    assert fd.launch_count() == 4 and fd.plain_count() == 0


# B4 cases: (B, H, KV, Sq, Sk, hd, causal, window) — every head dim with
# GQA at a ragged S, causal with and without a window of no multiple of a
# key tile, and non-causal with Sq != Sk
FA_CUDA_CASES = [(2, 4, 2, 45, 45, 80, True, 0), (2, 4, 2, 45, 45, 80, True, 16),
                 (1, 8, 2, 200, 200, 32, True, 100),
                 (1, 8, 2, 200, 200, 64, True, 0),
                 (1, 8, 2, 200, 200, 96, True, 100),
                 (1, 8, 2, 200, 200, 128, True, 0),
                 (1, 8, 2, 200, 200, 256, True, 100),
                 (2, 4, 2, 50, 77, 64, False, 0),
                 (1, 4, 1, 130, 70, 256, False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernels_match_plain_versions(cuda, dtype):
    """B4, B7 and B8 on the card against their plain versions at small
    shapes with a ragged S (B4 at every head dim, with GQA, windows and
    non-causal Sq != Sk): f32 within 2e-5·(1 + |plain|), x5 for B7 (the
    reference's tests' atol = rtol); bf16 within that plus one bf16 ulp,
    since both round the f32 result once (chip_smoke.py holds them at the
    model geometries)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ssd
    from repro_torch.kernels import wkv6 as wkv
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen, device=cuda)

    def close(got, want, scale=1.0):
        g, p = got.float(), want.float()
        limit = 2e-5 * scale * (1.0 + p.abs())
        if dtype == torch.bfloat16:
            a = torch.maximum(g.abs(), p.abs()).clamp_min(2.0 ** -126)
            limit = limit + torch.exp2(torch.floor(torch.log2(a)) - 7)
        assert bool(((g - p).abs() <= limit).all()), \
            float(((g - p).abs() / limit).max())

    for mod in (fa, ssd, wkv):
        mod.reset_counts()
    for b, h, kvh, sq, sk, hd, causal, w in FA_CUDA_CASES:
        q = rn(b, h, sq, hd).to(dtype)
        k, v = rn(b, kvh, sk, hd).to(dtype), rn(b, kvh, sk, hd).to(dtype)
        close(fa.flash_attention(q, k, v, causal=causal, window=w),
              fa.flash_attention_plain(q, k, v, causal=causal, window=w))
    x, B, C = rn(2, 3, 45, 32).to(dtype), (rn(2, 45, 16) * 0.3).to(dtype), \
        (rn(2, 45, 16) * 0.3).to(dtype)
    args = (x, rn(2, 3, 45).abs() * 0.1 + 0.01,
            torch.log(torch.linspace(1.0, 8.0, 3, device=cuda)), B, C,
            torch.ones(3, device=cuda))
    close(ssd.mamba_ssd_scan(*args), ssd.mamba_ssd_plain(*args), scale=5.0)
    r, kk, vv = ((rn(2, 4, 45, 64) * 0.5).to(dtype) for _ in range(3))
    w = torch.sigmoid(rn(2, 4, 45, 64)) * 0.5 + 0.5     # f32, as the model's
    u = rn(4, 64) * 0.3
    close(wkv.wkv6_chunked(r, kk, vv, w, u), wkv.wkv6_plain(r, kk, vv, w, u))
    assert (fa.launch_count(), ssd.launch_count(), wkv.launch_count()) == \
        (len(FA_CUDA_CASES), 1, 1)
    assert fa.plain_count() + ssd.plain_count() + wkv.plain_count() == 0


def _close_ssd(got, want, dtype):
    """Phase 14's B7 limit: 1e-4·(1 + |plain|), plus one bf16 ulp of the
    larger magnitude for bf16 outputs."""
    g, p = got.float(), want.float()
    limit = 1e-4 * (1.0 + p.abs())
    if dtype == torch.bfloat16:
        a = torch.maximum(g.abs(), p.abs()).clamp_min(2.0 ** -126)
        limit = limit + torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert bool(((g - p).abs() <= limit).all()), \
        float(((g - p).abs() / limit).max())


def _ssd_views(cuda, dtype, bt=2, s=150, h=6, p=64, n=32, offset=0):
    """The views ``mamba2_block`` hands B7: x, B and C columns of one
    (Bt, S, H·P + 2N) conv output (x as its (Bt, H, S, P) transpose; the
    columns start ``offset`` elements in), dt the transpose of a (Bt, S, H)
    f32 tensor."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=cuda)
    conv = torch.cat([rn(bt, s, offset), rn(bt, s, h * p),
                      rn(bt, s, 2 * n) * 0.3], dim=-1).to(dtype)
    o = offset
    x = conv[..., o:o + h * p].view(bt, s, h, p).transpose(1, 2)
    dt = (rn(bt, s, h).abs() * 0.1 + 0.01).transpose(1, 2)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=cuda))
    return (x, dt, a_log, conv[..., o + h * p:o + h * p + n],
            conv[..., o + h * p + n:], torch.ones(h, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_reads_the_block_views(cuda, dtype):
    """B7 on the strided views ``mamba2_block`` passes (S ragged to the
    bf16 route's chunks of 64) equals B7 on contiguous copies bit for bit,
    hands y back as the (Bt, H, S, P) view of (Bt, S, H, P) memory, and
    lies within phase 14's limit of the plain version."""
    from repro_torch.kernels import mamba_scan as ssd
    args = _ssd_views(cuda, dtype)
    assert not args[0].is_contiguous() and not args[3].is_contiguous()
    ssd.reset_counts()
    got = ssd.mamba_ssd_scan(*args)
    assert got.transpose(1, 2).is_contiguous()
    copies = ssd.mamba_ssd_scan(*(t.contiguous() for t in args))
    assert torch.equal(got, copies)
    _close_ssd(got, ssd.mamba_ssd_plain(*args), dtype)
    assert ssd.launch_count() == 2 and ssd.plain_count() == 0


def test_ssd_refuses_views_it_cannot_read(cuda):
    """A last dimension that is not contiguous, or (bf16, loaded by TMA) a
    base and row stride off 16 bytes, is refused with a ValueError, never
    copied."""
    from repro_torch.kernels import mamba_scan as ssd
    x, dt, a_log, B, C, D = _ssd_views(cuda, torch.float32, p=32)
    x_cols = x.transpose(2, 3).contiguous().transpose(2, 3)   # P strided
    b_cols = B.transpose(1, 2).contiguous().transpose(1, 2)   # N strided
    ssd.reset_counts()
    for bad in ((x_cols, dt, a_log, B, C, D), (x, dt, a_log, b_cols, C, D)):
        with pytest.raises(ValueError, match="contiguous last dimension"):
            ssd.mamba_ssd_scan(*bad)
    with pytest.raises(ValueError, match="16-byte"):
        ssd.mamba_ssd_scan(*_ssd_views(cuda, torch.bfloat16, offset=1))
    assert ssd.launch_count() == 0


def _wkv_views(cuda, dtype, b=2, s=150, h=4, kd=64, vd=64, offset=0):
    """What ``time_mix`` hands B8: (B, H, S, ·) views of (B, S, H, ·)
    r, k, v in ``dtype`` (their columns starting ``offset`` elements into a
    wider tensor) and of an f32 decay, with u."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=cuda)

    def view(c, scale=0.5):
        full = (rn(b, s, offset + h * c) * scale).to(dtype)
        return full[..., offset:].view(b, s, h, c).transpose(1, 2)
    r, k, v = view(kd), view(kd), view(vd)
    w = (torch.sigmoid(rn(b, s, h, kd)) * 0.5 + 0.5).transpose(1, 2)
    return r, k, v, w, rn(h, kd) * 0.3


@pytest.mark.parametrize("dtype,kd,vd", [(torch.bfloat16, 64, 64),
                                         (torch.bfloat16, 32, 32),
                                         (torch.bfloat16, 128, 64),
                                         (torch.float32, 64, 64)])
def test_wkv6_reads_the_block_views(cuda, dtype, kd, vd):
    """B8 on the views ``time_mix`` passes (bf16 or f32 r, k, v, f32 w; S
    ragged to the tensor-core route's chunks of 64) equals B8 on contiguous
    copies bit for bit, hands y back as the (B, H, S, V) view of (B, S, H,
    V) memory in ``out_dtype``, and lies within phase 14's limit of the
    plain version.  bf16 with K = 32 / 64 runs on the tensor cores, K = 128
    and f32 the step recurrence."""
    from repro_torch.kernels import wkv6 as wkv
    r, k, v, w, u = _wkv_views(cuda, dtype, kd=kd, vd=vd)
    assert not r.is_contiguous() and not w.is_contiguous()
    assert wkv.tensor_core_route(r, k) == (dtype == torch.bfloat16
                                           and kd <= 64)
    wkv.reset_counts()
    got = wkv.wkv6_chunked(r, k, v, w, u, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.transpose(1, 2).is_contiguous()
    copies = wkv.wkv6_chunked(*(t.contiguous() for t in (r, k, v, w)), u,
                              out_dtype=torch.float32)
    assert torch.equal(got, copies)
    want = wkv.wkv6_plain(r, k, v, w, u, out_dtype=torch.float32)
    limit = 2e-5 * (1.0 + want.abs())
    assert bool(((got - want).abs() <= limit).all()), \
        float(((got - want).abs() / limit).max())
    assert wkv.launch_count() == 2 and wkv.plain_count() == 0


def test_wkv6_refuses_inputs_it_cannot_read(cuda):
    """A last dimension that is not contiguous, a bf16 view whose base or
    strides are off 16 bytes (the tensor-core route loads by TMA) or a
    decay that is not f32 is refused with a ValueError, never copied."""
    from repro_torch.kernels import wkv6 as wkv
    r, k, v, w, u = _wkv_views(cuda, torch.bfloat16)
    cols = r.transpose(2, 3).contiguous().transpose(2, 3)      # K strided
    wkv.reset_counts()
    with pytest.raises(ValueError, match="contiguous last dimension"):
        wkv.wkv6_chunked(cols, k, v, w, u)
    with pytest.raises(ValueError, match="16-byte"):
        wkv.wkv6_chunked(*_wkv_views(cuda, torch.bfloat16, offset=1))
    with pytest.raises(ValueError, match="float32"):
        wkv.wkv6_chunked(r, k, v, w.to(torch.bfloat16), u)
    assert wkv.launch_count() == 0


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_every_cluster_size(cuda, kv_dtype):
    """B6 at every cluster size the wrapper can choose, on rows whose live
    keys leave most of 8 shares empty (and a dead row), with GQA and a
    window: within 2e-5 of its plain version at each (the split changes
    the float order only), one launch a call."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, h, kv, hd, page_len, pp, n_pages = 4, 8, 2, 96, 16, 16, 80
    q = torch.randn(rows, h, 1, hd, generator=gen, device=cuda)
    kp, vp = (torch.randn(n_pages, page_len, kv, hd, generator=gen,
                          device=cuda).to(kv_dtype) for _ in range(2))
    table = torch.randperm(n_pages, generator=gen, device=cuda)[
        :rows * pp].reshape(rows, pp).int()
    table[1] = n_pages                                   # dead row
    lengths = torch.tensor([255, 0, 40, 129], dtype=torch.int32, device=cuda)
    fd.reset_counts()
    for w in (0, 64):
        want = fd.paged_decode_ref(q, kp, vp, table, lengths, window=w)
        for split in fd.CLUSTER_SIZES:
            got = fd.flash_decode_paged(q, kp, vp, table, lengths, window=w,
                                        split=split)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert fd.launch_count() == 2 * len(fd.CLUSTER_SIZES)
    assert fd.plain_count() == 0


def test_prefill_step_launches_the_kernels(cuda):
    """make_prefill_step on a reduced f32 zamba2 (6 layers) on the card:
    one B7 launch per Mamba2 layer, one B4 per shared-block call, no plain
    run, finite logits."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ssd
    from repro_torch.launch.steps import make_prefill_step
    cfg = reduced(get_config("zamba2-2.7b"), layers=6)
    params = models.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 45), device=cuda)
    fa.reset_counts()
    ssd.reset_counts()
    logits = make_prefill_step(cfg)(params, tok)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert (ssd.launch_count(), fa.launch_count()) == (5, 1)
    assert ssd.plain_count() + fa.plain_count() == 0


def test_stateful_paths_refused_on_the_card(cuda):
    """A WKV state to start from and causal attention with a query offset
    raise on CUDA tensors, naming their items (B8 and B4 start from 0)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import attention, rwkv6
    cfg = reduced(get_config("rwkv6-7b"))
    x = torch.zeros(1, 4, cfg.d_model, device=cuda)
    state = torch.zeros(1, cfg.n_heads, cfg.head_dim, cfg.head_dim,
                        device=cuda)
    with pytest.raises(NotImplementedError, match="A14"):
        rwkv6.time_mix({}, x, cfg, wkv_state=state)
    q = torch.zeros(1, 2, 4, 16, device=cuda)
    kv = torch.zeros(1, 6, 2, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="A12"):
        attention.chunked_attention(q, kv, kv, q_offset=4)
