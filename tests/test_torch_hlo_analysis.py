"""The port's cost counter (``repro_torch.launch.hlo_analysis``) on known
programs, against the reference's HLO analyzer on the same prefill, and
the kernels' meta route under a count.

* the reference's four cases (``tests/test_hlo_analysis.py``) through the
  counter: one matmul exact, a loop of 8 and nested loops of 3 x 5
  counting every iteration, the roofline on the card's constants;
* a matmul of DTensors on a fake 256-rank (16, 16) mesh counts each
  rank's shard product, not the global one, and the redistribute's two
  all-gathers by kind, bytes and mesh axis;
* the counted FLOPs of a reduced ``phi3-mini-3.8b`` prefill within 1 % of
  the reference's ``analyze_hlo`` of its jitted step on the same inputs
  (S below one key block, so that both count one attention block);
* each kernel's meta route (B4, B5, B7, B8): the plain version's output
  shape and dtype, the formula's FLOPs and bytes added, one meta launch
  and no real one; refused outside a count.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import mamba_scan as ssd
from repro_torch.kernels import wkv6 as wkv
from repro_torch.launch import mesh as M
from repro_torch.launch.hlo_analysis import (CostCounter, fused,
                                             roofline_terms)
from repro_torch.launch.steps import make_prefill_step

torch.set_num_threads(1)


def _flops(fn, *args):
    with CostCounter() as c:
        fn(*args)
    return c.cost.flops


def _scan(w, x):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _nested(w, x):
    for i in range(w.shape[0]):
        for j in range(w.shape[1]):
            x = x @ w[i, j]
    return x


@pytest.mark.parametrize("fn,shapes,want", [
    (lambda a, b: a @ b, ((64, 128), (128, 32)), 2 * 64 * 128 * 32),
    (_scan, ((8, 64, 64), (4, 64)), 8 * 2 * 4 * 64 * 64),
    (_nested, ((3, 5, 32, 32), (2, 32)), 15 * 2 * 2 * 32 * 32),
], ids=["single_matmul", "loop_of_8", "nested_3x5"])
def test_every_iteration_counts(fn, shapes, want):
    """The reference parses trip counts because XLA counts a while body
    once; eager dispatch sees every iteration."""
    args = [torch.randn(*s) for s in shapes]
    assert _flops(fn, *args) == want


def test_roofline_terms_on_the_cards_constants():
    r = roofline_terms(per_device_flops=989e12, per_device_bytes=3.35e12,
                       per_device_collective_bytes=50e9, n_chips=256,
                       model_flops=1e15)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory", "collective")
    assert r.step_time_s == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1e15 / (989e12 * 256))
    # per axis: each axis's bytes over its own link
    r2 = roofline_terms(per_device_flops=0.0, per_device_bytes=0.0,
                        per_device_collective_bytes=950e9, n_chips=8,
                        model_flops=0.0,
                        collective_by_axis={"model": 900e9, "data": 50e9},
                        axis_bw={"model": 900e9, "data": 50e9})
    assert r2.collective_s == pytest.approx(2.0)
    assert r2.dominant == "collective"


@pytest.mark.parametrize("shape,axes,want", [
    ((16, 16), ("data", "model"), {"data": "infiniband",
                                   "model": "infiniband"}),
    ((2, 16, 16), ("pod", "data", "model"),
     {"pod": "infiniband", "data": "infiniband", "model": "infiniband"}),
    ((32, 8), ("data", "model"), {"data": "infiniband", "model": "nvlink"}),
    ((64, 2, 2), ("pod", "data", "model"),
     {"pod": "infiniband", "data": "nvlink", "model": "nvlink"}),
    ((1, 8), ("data", "model"), {"data": "nvlink", "model": "nvlink"}),
])
def test_axis_links(shape, axes, want):
    """An axis is priced at the slowest link it crosses, nodes of 8."""
    assert M.axis_links(shape, axes) == want


def test_link_constants_are_the_datasheets():
    assert M.PEAK_FLOPS_BF16 == 989e12 and M.HBM_BW == 3.35e12
    assert M.link_bandwidth("nvlink") == pytest.approx(900e9)
    assert M.link_bandwidth("infiniband") == pytest.approx(50e9)


def test_dtensor_matmul_counts_each_ranks_shards():
    """Finding 2 of the slice: 256 fake ranks, (16, 16); a (4096, 1024)
    @ (1024, 8192) product sharded [S(0), R] x [R, S(1)] is 268,435,456
    FLOPs a rank (FlopCounterMode counts the global 68.7 G); the
    redistribute to [R, R] is two all-gathers."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    with fake_world(256):
        mesh = M._mesh((16, 16), ("data", "model"), "cpu")
        a = torch.empty(4096, 1024, device="meta")
        b = torch.empty(1024, 8192, device="meta")
        A = DTensor.from_local(a.chunk(16, 0)[0], mesh, [Shard(0),
                                                         Replicate()],
                               run_check=False, shape=a.shape,
                               stride=a.stride())
        B = DTensor.from_local(b.chunk(16, 1)[0], mesh, [Replicate(),
                                                         Shard(1)],
                               run_check=False, shape=b.shape,
                               stride=b.stride())
        with CostCounter(mesh) as c:
            C = A @ B
            C.redistribute(mesh, [Replicate(), Replicate()])
    cost = c.cost
    assert cost.flops == 268_435_456 == 2 * 256 * 512 * 1024
    assert cost.collective_counts == {"all-gather": 2}
    # over model: (256, 512) -> (256, 8192), gathered as (4096, 512);
    # then over data: (256, 8192) -> (4096, 8192)
    assert cost.collective_by_axis == {"model": 4096 * 512 * 4,
                                       "data": 4096 * 8192 * 4}
    assert cost.collective_by_kind == {"all-gather": 142_606_336}
    assert cost.dot_bytes == (256 * 1024 + 1024 * 512 + 256 * 512) * 4


def test_phi3_prefill_flops_match_the_references_hlo():
    """A reduced phi3-mini prefill (2 layers, S = 45 < one key block)
    counted by the port on the CPU against the reference's analyze_hlo of
    the same jitted step: within 1 %."""
    seq = 45
    jcfg = jreduced(jget_config("phi3-mini-3.8b"), layers=2)
    cfg = reduced(get_config("phi3-mini-3.8b"), layers=2)
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              "cpu")
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    step = jax.jit(jmake_prefill_step(jcfg))
    want = analyze_hlo(step.lower(jp, jnp.asarray(tok)).compile()
                       .as_text()).flops
    with CostCounter() as c:
        make_prefill_step(cfg)(tp, torch.from_numpy(tok))
    got = c.cost.flops
    assert got == pytest.approx(want, rel=0.01), (got, want)


def test_fused_plain_form_keeps_intermediates_out_of_flash_bytes():
    """The CPU attention scan runs under ``fused``: its scores and
    probabilities count in dot_bytes, not in dot_bytes_flash."""
    from repro_torch.models.attention import chunked_attention
    q = torch.randn(1, 64, 2, 32)
    kv = torch.randn(1, 64, 2, 32)
    with CostCounter() as c:
        out = chunked_attention(q, kv, kv)
    cost = c.cost
    assert cost.flops == 2 * (2 * 2 * 64 * 64 * 32)
    assert cost.dot_bytes_flash < cost.dot_bytes
    # q, k, v read by the products (q twice: scale, then the scores) and
    # the output written; no score slab
    assert cost.dot_bytes_flash <= 5 * q.numel() * 4
    assert torch.isfinite(out).all()
    assert fused(lambda x: x + 1, q).shape == q.shape


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _cases():
    bf = torch.bfloat16
    return {
        "flash_attention": (
            lambda d, dt: fa.flash_attention(
                torch.empty(2, 4, 48, 64, dtype=dt, device=d),
                torch.empty(2, 2, 48, 64, dtype=dt, device=d),
                torch.empty(2, 2, 48, 64, dtype=dt, device=d),
                causal=True, window=16, q_offset=0),
            lambda: fa.flash_attention_work(_meta(2, 4, 48, 64, dtype=bf),
                                            _meta(2, 2, 48, 64, dtype=bf),
                                            _meta(2, 2, 48, 64, dtype=bf),
                                            window=16),
            fa, bf),
        "flash_decode": (
            lambda d, dt: fd.flash_decode(
                torch.zeros(2, 4, 1, 64, dtype=dt, device=d),
                torch.zeros(2, 2, 40, 64, dtype=dt, device=d),
                torch.zeros(2, 2, 40, 64, dtype=dt, device=d), 30),
            lambda: fd.flash_decode_work(_meta(2, 4, 1, 64, dtype=bf),
                                         _meta(2, 2, 40, 64, dtype=bf), 30),
            fd, bf),
        "mamba_ssd_scan": (
            lambda d, dt: ssd.mamba_ssd_scan(
                torch.zeros(1, 2, 70, 32, dtype=dt, device=d),
                torch.zeros(1, 2, 70, device=d), torch.zeros(2, device=d),
                torch.zeros(1, 70, 16, dtype=dt, device=d),
                torch.zeros(1, 70, 16, dtype=dt, device=d),
                torch.zeros(2, device=d)),
            lambda: ssd.mamba_ssd_work(
                _meta(1, 2, 70, 32, dtype=bf), _meta(1, 2, 70), _meta(2),
                _meta(1, 70, 16, dtype=bf), _meta(1, 70, 16, dtype=bf),
                _meta(2)),
            ssd, bf),
        "wkv6_chunked": (
            lambda d, dt: wkv.wkv6_chunked(
                *(torch.zeros(1, 2, 70, 32, dtype=dt, device=d)
                  for _ in "rkv"),
                torch.full((1, 2, 70, 32), 0.9, device=d),
                torch.zeros(2, 32, device=d), out_dtype=torch.float32),
            lambda: wkv.wkv6_work(
                *(_meta(1, 2, 70, 32, dtype=bf) for _ in "rkv"),
                _meta(1, 2, 70, 32), _meta(2, 32), out_dtype=torch.float32),
            wkv, bf),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_kernel_meta_route_under_a_count(name):
    call, work, mod, dt = _cases()[name]
    plain = call("cpu", dt)
    mod.reset_counts()
    with CostCounter() as c:
        out = call("meta", dt)
    assert out.device.type == "meta"
    assert tuple(out.shape) == tuple(plain.shape)
    assert out.dtype == plain.dtype
    flops, nbytes = work()
    assert flops > 0 and nbytes > 0
    assert c.cost.flops == flops
    assert c.cost.dot_bytes == c.cost.dot_bytes_flash == nbytes
    assert c.cost.kernels[name]["launches"] == 1
    assert mod.meta_count(name) == 1
    assert mod.launch_count(name) == 0
    # outside a count a meta tensor holds no data: refused
    with pytest.raises(ValueError, match=f"no {name} kernel for meta"):
        call("meta", dt)
    mod.reset_counts()


def test_kernel_formulas():
    """B4 skips the masked pairs (causal, window, offset); B5 reads the
    live keys only, a tensor pos at the cache's end; B7 / B8 by route."""
    assert fa.band_pairs(4, 4) == 10
    assert fa.band_pairs(4, 4, causal=False) == 16
    assert fa.band_pairs(4, 4, window=2) == 7
    assert fa.band_pairs(2, 6, q_offset=4) == 5 + 6
    assert fa.band_pairs(2, 6, q_offset=4, window=3) == 6
    q, k = _meta(1, 8, 1, 64), _meta(1, 2, 100, 64)
    f, b = fd.flash_decode_work(q, k, 9)
    assert f == 10 * 8 * 64 * 4
    assert b == 10 * 2 * 64 * 2 * 4 + 2 * q.numel() * 4
    assert fd.flash_decode_work(q, k, _meta((), dtype=torch.int32))[0] \
        == 100 * 8 * 64 * 4
    assert fd.flash_decode_work(q, k, 99, window=16)[0] == 16 * 8 * 64 * 4
    x, dt = _meta(1, 2, 64, 32), _meta(1, 2, 64)
    assert ssd.mamba_ssd_work(x, dt, _meta(2), _meta(1, 64, 16),
                              _meta(1, 64, 16), _meta(2))[0] \
        == 5 * 32 * 16 * 64 * 2
    r = _meta(1, 2, 64, 128, dtype=torch.bfloat16)
    assert wkv.wkv6_work(r, r, _meta(1, 2, 64, 64, dtype=torch.bfloat16),
                         _meta(1, 2, 64, 128), _meta(2, 128))[0] \
        == 7 * 128 * 64 * 64 * 2


def test_no_xla_flags_leak():
    """The reference's dry run sets XLA_FLAGS at import; nothing here
    imports it."""
    assert "force_host_platform_device_count=512" not in os.environ.get(
        "XLA_FLAGS", "")
