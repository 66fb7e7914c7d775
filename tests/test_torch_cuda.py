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
                 (1, 4, 1, 130, 70, 256, False, 0),
                 # granite-moe-3b-a800m's n_rep 3 at hd 64 (reduced heads)
                 (2, 6, 2, 45, 45, 64, True, 0)]


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
    """A whole-sequence WKV from a state raises on CUDA tensors (B8 starts
    from zero; no reference path asks for it); causal attention with a
    query offset runs B4 with that offset, within 2e-5 of its plain
    version on the same tensors moved to the CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, rwkv6
    cfg = reduced(get_config("rwkv6-7b"))
    x = torch.zeros(1, 4, cfg.d_model, device=cuda)
    state = torch.zeros(1, cfg.n_heads, cfg.head_dim, cfg.head_dim,
                        device=cuda)
    with pytest.raises(NotImplementedError, match="from a WKV state"):
        rwkv6.time_mix({}, x, cfg, wkv_state=state)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, 2, 4, 32, generator=gen, device=cuda)
    kv = torch.randn(1, 6, 2, 32, generator=gen, device=cuda)
    fa.reset_counts()
    got = attention.chunked_attention(q, kv, kv, q_offset=4, window=3)
    assert fa.launch_count() == 1
    want = attention.chunked_attention(q.cpu(), kv.cpu(), kv.cpu(),
                                       q_offset=4, window=3)
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=2e-5)


def test_fused_lm_step_on_the_card(cuda):
    """One fused dual-batch SGD step of reduced f32 phi3-mini through
    ``api.run`` on the card: one ``dbl_apply_flat2d`` launch and no B4
    launch (the training forward runs the differentiable scan), params on
    the card and within 1e-5 of the same step on the CPU port
    (``chip_smoke.py`` phase 19 holds whole runs of every reduced LM)."""
    import argparse

    from repro_torch import api, models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data import DataPlane, SyntheticTokens
    from repro_torch.engine import TrainEngine
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import build_spec
    from repro_torch.optim import sgd_momentum
    cfg = reduced(get_config("phi3-mini-3.8b"))
    spec = build_spec(argparse.Namespace(
        scheme="dbl", seq=32, global_batch=16, steps=1, lr=5e-3, k=1.05,
        n_small=3, micro_steps=0, seed=0))
    p0 = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        engine = TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True,
                             device=dev)
        K.reset_counts()
        fa.reset_counts()
        out[dev] = api.run(
            spec, api.RunConfig(backend="spmd", log_every=1),
            init_params=tree_map(lambda t: t.to(dev), p0), engine=engine,
            plane=DataPlane(SyntheticTokens(vocab=256, n_examples=1024),
                            seed=0))
        if dev == "cuda":
            assert K.launch_count("dbl_apply_flat2d", "plain") == 1
            assert K.launch_count() == 1 and K.plain_count() == 0
            assert fa.launch_count() + fa.plain_count() == 0
    for a, b in zip(tree_leaves(out["cuda"].params),
                    tree_leaves(out["cpu"].params)):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= 1e-5


@pytest.mark.parametrize("n_cand,n_workers", [(1, 3), (3, 3), (1, 4),
                                              (3, 4)])
@pytest.mark.parametrize("master", [False, True], ids=["f32", "master"])
def test_batched_worker_update_matches_single_launches(cuda, master, n_cand,
                                                       n_workers):
    """B3's candidate-batched form: one launch bit-equal to C launches of
    the one-store B3 with each candidate's own scalars, and to its plain
    version; only row block (c, wid) of the velocity changes."""
    from repro_torch.kernels import dbl_merge as K
    rows, wid = 3072, n_workers - 2
    gen = torch.Generator(device="cuda").manual_seed(n_cand * 10 + n_workers)
    rn = lambda *s: torch.randn(*s, rows, 128, generator=gen, device=cuda)
    w, g, v = rn(n_cand), rn(n_cand), rn(n_cand, n_workers)
    scal = [torch.tensor(x[:n_cand], device=cuda) for x in
            ((0.05, 0.01, 0.3), (0.9365079365079365, 1.0, 0.5),
             (0.9, 0.0, 0.5))]
    host = [t.cpu().tolist() for t in scal]

    def state():
        s = {"w": w.clone(), "v": v.clone()}
        if master:
            s["shadow"] = w.to(torch.bfloat16)
        return s
    batched, single, plain = state(), state(), state()
    K.reset_counts()
    kw = {"masterC": batched["w"]} if master else {}
    K.dbl_apply_worker_batched(batched["shadow"] if master else batched["w"],
                               g, batched["v"], wid, *scal, **kw)
    for c in range(n_cand):
        args = (g[c], single["v"][c], wid, host[0][c], host[1][c],
                host[2][c])
        if master:
            K.dbl_apply_worker_flat2d(single["shadow"][c], *args,
                                      master2=single["w"][c])
        else:
            K.dbl_apply_worker_flat2d(single["w"][c], *args)
    kw = {"masterC": plain["w"]} if master else {}
    K.dbl_apply_worker_batched_plain(plain["shadow"] if master
                                     else plain["w"], g, plain["v"], wid,
                                     *scal, **kw)
    torch.cuda.synchronize()
    variant = "master" if master else "plain"
    assert K.launch_count("dbl_apply_worker_batched", variant) == 1
    assert K.launch_count("dbl_apply_worker_flat2d", variant) == n_cand
    assert K.plain_count() == 0
    for k in batched:
        assert torch.equal(batched[k], single[k]), k
        assert torch.equal(batched[k], plain[k]), k
    for c in range(n_cand):
        for i in range(n_workers):
            assert torch.equal(batched["v"][c, i], v[c, i]) == (i != wid)
    if master:
        assert torch.equal(batched["shadow"],
                           batched["w"].to(torch.bfloat16))


def _close_decode(got, want, dtype):
    """f32 within 2e-5·(1 + |plain|); bf16 one bf16 ulp of the larger
    magnitude more (both round the f32 result once)."""
    g, p = got.float(), want.float()
    limit = 2e-5 * (1.0 + p.abs())
    if dtype == torch.bfloat16:
        a = torch.maximum(g.abs(), p.abs()).clamp_min(2.0 ** -126)
        limit = limit + torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert bool(((g - p).abs() <= limit).all()), \
        float(((g - p).abs() / limit).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window", [(80, 0), (96, 0), (256, 24), (48, 5)])
def test_flash_decode_reads_the_layer_cache(cuda, dtype, hd, window):
    """B5 on the models' (B, S, KV, hd) layer cache, read in place through
    its transpose(1, 2) view (no copy), at hd 80 (zamba2-2.7b's shared
    attention) and other multiples of 16, positions 0, the middle and the
    last, against its plain version on the same tensors."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(hd)
    b, h, kv, s = 3, 8, 2, 77
    q = torch.randn(b, h, 1, hd, generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn(b, s, kv, hd, generator=gen, device=cuda)
              .to(dtype) for _ in range(2))
    fd.reset_counts()
    for pos in (0, s // 2, s - 1):
        got = fd.flash_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), pos,
                              window=window)
        want = fd._xla_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), pos,
                              window=window)
        _close_decode(got, want, dtype)
    assert fd.launch_count("flash_decode") == 3 and fd.plain_count() == 0


# B5 cases: (hd, heads, kv heads, cache length, window) — zamba2-2.7b's hd
# 80 (a bf16 row no whole number of the 4 lanes' chunks), phi3-mini's 96,
# gemma3-4b's 256 with GQA and a window, n_rep 4
B5_SPLIT_CASES = [(80, 4, 4, 64, 0), (96, 4, 2, 150, 0), (256, 4, 2, 200, 24),
                  (64, 8, 2, 77, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,h,kv,s,window", B5_SPLIT_CASES)
def test_flash_decode_every_cluster_size(cuda, dtype, hd, h, kv, s, window):
    """B5 at every cluster size the wrapper can choose, on the layer
    cache's (B, S, KV, hd) view, at positions 0, the middle and the last
    (short ranges leave most of 8 shares empty): within 2e-5 of its plain
    version at each (bf16 one ulp more), one launch a call."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(hd + s)
    b = 3
    q = torch.randn(b, h, 1, hd, generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn(b, s, kv, hd, generator=gen, device=cuda)
              .to(dtype).transpose(1, 2) for _ in range(2))
    fd.reset_counts()
    for pos in (0, s // 2, s - 1):
        want = fd._xla_decode(q, kc, vc, pos, window=window)
        for split in fd.CLUSTER_SIZES:
            _close_decode(fd.flash_decode(q, kc, vc, pos, window=window,
                                          split=split), want, dtype)
    assert fd.launch_count("flash_decode") == 3 * len(fd.CLUSTER_SIZES)
    assert fd.plain_count() == 0


def _b5_inputs(cuda, dtype=torch.bfloat16, b=4, h=8, kv=4, hd=96, s=300):
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn(b, h, 1, hd, generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn(b, s, kv, hd, generator=gen, device=cuda)
              .to(dtype).transpose(1, 2) for _ in range(2))
    return q, kc, vc


def test_flash_decode_device_pos_equals_host_int(cuda):
    """B5 with pos a 0-d int32 tensor on the card gives the bits of the
    host int, at every cluster size and with a window; a pos tensor of
    another dtype, shape or device is refused."""
    from repro_torch.kernels import flash_decode as fd
    q, kc, vc = _b5_inputs(cuda)
    for pos in (0, 151, 299):
        dev = torch.tensor(pos, dtype=torch.int32, device=cuda)
        for split in fd.CLUSTER_SIZES:
            for w in (0, 40):
                assert torch.equal(
                    fd.flash_decode(q, kc, vc, dev, window=w, split=split),
                    fd.flash_decode(q, kc, vc, pos, window=w, split=split))
    for bad in (torch.tensor(3.0, device=cuda),
                torch.tensor([3], dtype=torch.int32, device=cuda),
                torch.tensor(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            fd.flash_decode(q, kc, vc, bad)


def test_flash_decode_replays_in_a_cuda_graph(cuda):
    """One B5 launch captured in a CUDA graph with its position in a
    device tensor, replayed at three positions written into that tensor:
    bit-equal to eager launches at each, so the launch's arguments serve
    every position."""
    from repro_torch.kernels import flash_decode as fd
    q, kc, vc = _b5_inputs(cuda)
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    fd.flash_decode(q, kc, vc, pos, window=64)           # build, warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode(q, kc, vc, pos, window=64)
    for p in (5, 170, 299):
        pos.fill_(p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fd.flash_decode(q, kc, vc, p, window=64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_with_a_query_offset(cuda, dtype):
    """B4 with queries at offset..offset+T-1 over the first offset + T keys
    (offsets 0, 1, 17 and 70; T 1, 5 and 64; with and without a window),
    against its plain version."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)
    fa.reset_counts()
    n = 0
    for off in (0, 1, 17, 70):
        for t in (1, 5, 64):
            for w in (0, 24):
                q, k, v = rn(2, 4, t, 64), rn(2, 2, off + t, 64), \
                    rn(2, 2, off + t, 64)
                _close_decode(
                    fa.flash_attention(q, k, v, window=w, q_offset=off),
                    fa.flash_attention_plain(q, k, v, window=w,
                                             q_offset=off), dtype)
                n += 1
    assert fa.launch_count() == n and fa.plain_count() == 0


# B4 over a whole (B, S, KV, hd) layer cache through its transpose(1, 2)
# view at a device offset: (hd, window, T, offset) — phi3's hd 96, gemma3's
# hd 256 with a window of no multiple of a key tile, a ragged chunk, the
# cache's last chunk
B4_CACHE_CASES = [(96, 0, 64, 512), (96, 0, 17, 40), (256, 24, 64, 448),
                  (64, 0, 64, 0), (64, 16, 5, 507)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,window,t,off", B4_CACHE_CASES)
def test_flash_attention_reads_the_cache_at_a_device_offset(cuda, dtype, hd,
                                                            window, t, off):
    """B4 on the layer cache's strided views with q_offset a 0-d int32 on
    the card: against its plain version on the same views, and bit-equal
    to the host-int launch (the same tiles in the same order)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(hd + t + off)
    rn = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)
    b, h, kv, max_seq = 2, 8, 2, 512 + 64
    q = rn(b, h, t, hd)
    kc, vc = rn(b, max_seq, kv, hd), rn(b, max_seq, kv, hd)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    assert not k.is_contiguous() and fa.readable(k)
    pos = torch.tensor(off, dtype=torch.int32, device=cuda)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, window=window, q_offset=pos)
    host = fa.flash_attention(q, k, v, window=window, q_offset=off)
    assert fa.launch_count() == 2 and fa.plain_count() == 0
    assert torch.equal(got, host)
    _close_decode(got, fa.flash_attention_plain(q, k, v, window=window,
                                                q_offset=pos), dtype)


def test_flash_attention_refuses_views_it_cannot_read(cuda):
    """A bf16 key stride of no whole 16 bytes, a last dimension that is not
    contiguous, a q that is not contiguous, and an offset that is not a
    0-d int32 on the card are refused; nothing is copied quietly, and
    ``readable`` says which views a caller must copy."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(1, 4, 8, 64, generator=gen, device=cuda).bfloat16()
    pad = torch.randn(1, 32, 2, 68, generator=gen, device=cuda).bfloat16()
    odd = pad[..., :64].transpose(1, 2)           # 136-byte key rows
    assert not fa.readable(odd) and fa.readable(odd.float())
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(q, odd, odd, q_offset=8)
    cols = torch.randn(1, 2, 64, 32, generator=gen, device=cuda).bfloat16() \
        .transpose(2, 3)
    with pytest.raises(ValueError, match="strides"):
        fa.flash_attention(q, cols, cols)
    k = torch.randn(1, 2, 32, 64, generator=gen, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="contiguous q"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, k)
    for bad in (torch.tensor(8, device=cuda), torch.tensor(8, dtype=torch.int32),
                torch.tensor([8], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="0-d int32"):
            fa.flash_attention(q, k, k, q_offset=bad)


def test_decode_chunk_at_a_device_pos_card_vs_cpu(cuda):
    """``decode_step`` with a chunk at a 0-d int32 ``pos`` on the card (B4
    on the cache views, no slice) against the CPU port at the same
    tensor pos, reduced f32 phi3-mini, a write the cache clamps
    included: logits within 1e-4, the same cache rows written."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.kernels import flash_attention as fa
    cfg = reduced(get_config("phi3-mini-3.8b"))
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    cards = tree_map(lambda t: t.cuda(), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    for pos in (5, 40):                      # 40 + 17 > 48: clamped to 31
        caches = {d: models.init_cache(cfg, 2, 48, device=d)
                  for d in ("cpu", "cuda")}
        fa.reset_counts()
        got, _ = models.decode_step(
            cards, cfg, caches["cuda"], toks.cuda(),
            torch.tensor(pos, dtype=torch.int32, device=cuda))
        assert fa.launch_count() == cfg.n_layers
        want, _ = models.decode_step(params, cfg, caches["cpu"], toks,
                                     torch.tensor(pos, dtype=torch.int32))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
        for a, b in zip(tree_flatten(caches["cuda"])[0],
                        tree_flatten(caches["cpu"])[0]):
            assert torch.equal(a.cpu() != 0, b != 0)


def test_static_generate_launches_the_kernels(cuda):
    """``launch.serve.generate`` on reduced f32 phi3-mini on the card: one
    B4 launch a layer for the chunked prefill, one B5 launch a layer a
    decode step, no plain run, and the CPU port's greedy tokens."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import generate
    cfg = reduced(get_config("phi3-mini-3.8b"))
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    fa.reset_counts()
    fd.reset_counts()
    card = generate(cfg, tree_map(lambda t: t.cuda(), params),
                    prompts.cuda(), gen=5, max_seq=17)
    assert (fa.launch_count(), fd.launch_count("flash_decode")) == \
        (cfg.n_layers, cfg.n_layers * 4)
    assert fa.plain_count() + fd.plain_count() == 0
    cpu = generate(cfg, params, prompts, gen=5, max_seq=17)
    assert torch.equal(card.cpu(), cpu)


# granite-moe-3b-a800m's attention: n_rep 3 at hd 64, full (24 / 8 heads)
# and reduced (6 / 2); B5 and B6 serve the 3 heads of a KV head from their
# kRep = 4 form, a ragged group
GRANITE_DECODE = [(24, 8), (6, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", GRANITE_DECODE)
def test_flash_decode_at_granite_geometry(cuda, dtype, h, kv):
    """B5 on the (B, S, KV, hd) layer cache at n_rep 3, hd 64, every
    cluster size, positions 0, the middle and the last: within 2e-5 of its
    plain version (bf16 one ulp more)."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(h)
    b, hd, s = 4, 64, 200
    q = torch.randn(b, h, 1, hd, generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn(b, s, kv, hd, generator=gen, device=cuda)
              .to(dtype).transpose(1, 2) for _ in range(2))
    fd.reset_counts()
    for pos in (0, s // 2, s - 1):
        want = fd._xla_decode(q, kc, vc, pos)
        for split in fd.CLUSTER_SIZES:
            _close_decode(fd.flash_decode(q, kc, vc, pos, split=split),
                          want, dtype)
    assert fd.launch_count("flash_decode") == 3 * len(fd.CLUSTER_SIZES)
    assert fd.plain_count() == 0


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", GRANITE_DECODE)
def test_paged_decode_at_granite_geometry(cuda, kv_dtype, h, kv):
    """B6 at n_rep 3, hd 64, every cluster size, a scrambled page table
    and a dead row, with and without a window: within 2e-5 of its plain
    version."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(h + 1)
    rows, hd, page_len, pp, n_pages = 4, 64, 16, 16, 80
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


def test_granite_paths_launch_the_kernels(cuda):
    """Reduced f32 granite-moe-3b-a800m (6 / 2 heads of 64) on the card:
    a prefill makes one B4 launch a layer; ``generate`` one B4 a layer and
    one B5 a layer a decode step, no plain run, and the CPU port's greedy
    tokens."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_prefill_step
    cfg = reduced(get_config("granite-moe-3b-a800m"), d_model=384,
                  n_heads=6)
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    card_params = tree_map(lambda t: t.cuda(), params)
    prompts = torch.randint(0, cfg.vocab_size, (2, 12),
                            generator=torch.Generator().manual_seed(1))
    fa.reset_counts()
    fd.reset_counts()
    logits = make_prefill_step(cfg)(card_params, prompts.cuda())
    assert fa.launch_count() == cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    fa.reset_counts()
    card = generate(cfg, card_params, prompts.cuda(), gen=5, max_seq=17)
    assert (fa.launch_count(), fd.launch_count("flash_decode")) == \
        (cfg.n_layers, cfg.n_layers * 4)
    assert fa.plain_count() + fd.plain_count() == 0
    cpu = generate(cfg, params, prompts, gen=5, max_seq=17)
    assert torch.equal(card.cpu(), cpu)


# seamless-m4t-large-v2's cross-attention in a decode step: one query over
# the encoder's keys, non-causal, 16 / 16 heads of 64 (full) and the
# reduced model's 4 / 4
CROSS_DECODE = [(4, 16, 16, 4096), (2, 4, 4, 64), (3, 4, 2, 77)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sk", CROSS_DECODE)
def test_flash_attention_one_query_noncausal(cuda, dtype, b, h, kv, sk):
    """B4 at Sq = 1, non-causal (the TMA box of 64 query rows over a
    one-row query head in bf16): within 2e-5 of its plain version (bf16
    one ulp more); B5 at pos = Sk - 1 with no window computes the same
    function on the same keys."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(sk)
    rn = lambda *s: torch.randn(*s, generator=gen, device=cuda).to(dtype)
    q, k, v = rn(b, h, 1, 64), rn(b, kv, sk, 64), rn(b, kv, sk, 64)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    _close_decode(got, want, dtype)
    _close_decode(fd.flash_decode(q, k, v, sk - 1), want, dtype)
    assert fa.launch_count() == 1 and fa.plain_count() == 0


def test_encdec_paths_launch_the_kernels(cuda):
    """Reduced f32 seamless on the card: the prefill launches B4 in each
    encoder layer, each decoder layer and each cross-attention; a decode
    step one B5 and one B4 (the cross-attention at one query) a layer; no
    plain run; the CPU port's logits within 1e-4 and its greedy tokens."""
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec
    cfg = reduced(get_config("seamless-m4t-large-v2"))
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    card = tree_map(lambda t: t.cuda(), params)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    frames = torch.randn(2, cfg.encoder_seq, cfg.d_model, generator=gen)
    fa.reset_counts()
    fd.reset_counts()
    got = make_prefill_step(cfg)(card, tok.cuda(), frames.cuda())
    assert fa.launch_count() == cfg.encoder_layers + 2 * cfg.n_layers
    want = make_prefill_step(cfg)(params, tok, frames)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    outs = []
    for p, dev in ((card, cuda), (params, torch.device("cpu"))):
        cache = models.init_cache(cfg, 2, 9, device=dev)
        with torch.inference_mode():
            cache["enc_out"] = encdec.encode(p, cfg, frames.to(dev))
        step, t, seen = make_decode_step(cfg), tok[:, :1].to(dev), []
        fa.reset_counts()
        fd.reset_counts()
        for s in range(8):
            logits, cache = step(p, cache, t, torch.tensor(
                s, dtype=torch.int32, device=dev))
            t = logits.argmax(-1)[:, None]
            seen.append(logits.cpu())
        if dev.type == "cuda":
            assert (fd.launch_count("flash_decode"), fa.launch_count()) == \
                (8 * cfg.n_layers, 8 * cfg.n_layers)
            assert fa.plain_count() + fd.plain_count() == 0
        outs.append(torch.stack(seen))
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))


# the attention of llama3-405b (128 / 8 heads, n_rep 16), deepseek-67b and
# chameleon-34b (64 / 8, n_rep 8) and arctic-480b (56 / 8, n_rep 7) at hd
# 128: B5 and B6 serve 8 query heads a block (kRep 8), two groups a KV
# head, one, and one of 7 in 8
WIDE_GQA = [(128, 8), (64, 8), (56, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", WIDE_GQA)
def test_flash_decode_at_wide_gqa(cuda, dtype, h, kv):
    """B5 on the (B, S, KV, hd) layer cache at hd 128 and n_rep 16 / 8 /
    7, every cluster size, positions 0, the middle and the last, and a
    window: within 2e-5 of its plain version (bf16 one ulp more)."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(h)
    b, hd, s = 2, 128, 300
    q = torch.randn(b, h, 1, hd, generator=gen, device=cuda).to(dtype)
    kc, vc = (torch.randn(b, s, kv, hd, generator=gen, device=cuda)
              .to(dtype).transpose(1, 2) for _ in range(2))
    fd.reset_counts()
    for pos, w in ((0, 0), (s // 2, 0), (s - 1, 0), (s - 1, 100)):
        want = fd._xla_decode(q, kc, vc, pos, window=w)
        for split in fd.CLUSTER_SIZES:
            _close_decode(fd.flash_decode(q, kc, vc, pos, window=w,
                                          split=split), want, dtype)
    assert fd.launch_count("flash_decode") == 4 * len(fd.CLUSTER_SIZES)
    assert fd.plain_count() == 0


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", WIDE_GQA)
def test_paged_decode_at_wide_gqa(cuda, kv_dtype, h, kv):
    """B6 at hd 128 and n_rep 16 / 8 / 7, every cluster size, a scrambled
    page table and a dead row, with and without a window: within 2e-5 of
    its plain version."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(h + 1)
    rows, hd, page_len, pp, n_pages = 4, 128, 16, 16, 80
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


def test_windowed_decode_step_card_vs_cpu(cuda):
    """Reduced f32 llama3-405b (16 / 1 heads of 128, n_rep 16) through
    ``make_decode_step(cfg, shape)`` at a long_500k-named shape (64
    positions, window 16): a 40-token chunk (one B4 a layer) and 4
    one-token steps past the window (one B5 a layer each) on the card, the
    logits within 1e-4 of the CPU port's; the step without the shape
    differs."""
    from dataclasses import replace

    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import InputShape
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.steps import make_decode_step
    cfg = replace(reduced(get_config("llama3-405b"), n_heads=16,
                          d_model=2048), attn_window_override=16)
    shape = InputShape("long_500k", 64, 2, "decode")
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 44),
                         generator=torch.Generator().manual_seed(1))

    def run(p, device, s=shape):
        step = make_decode_step(cfg, s)
        cache = models.init_cache(cfg, 2, 64, device=device)
        for a, b in [(0, 40), (40, 41), (41, 42), (42, 43), (43, 44)]:
            logits, cache = step(p, cache, toks[:, a:b].to(device), a)
        return logits.cpu()
    on_card = tree_map(lambda t: t.to(cuda), params)
    fa.reset_counts()
    fd.reset_counts()
    card = run(on_card, cuda)
    assert fa.launch_count() == cfg.n_layers
    assert fd.launch_count("flash_decode") == 4 * cfg.n_layers
    assert fa.plain_count() == fd.plain_count() == 0
    cpu = run(params, "cpu")
    assert float((card - cpu).abs().max()) <= 1e-4
    assert float((run(on_card, cuda, None) - card).abs().max()) > 1e-3
