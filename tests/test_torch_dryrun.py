"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: the analytic model FLOPs and device bytes for every (arch x
shape) pair, ``run_one`` of each step kind on a 4-rank (2, 2) fake mesh
with the reference's record keys, and the reference test's combination
(granite-moe-3b-a800m x decode_32k on both production meshes) through
``main`` on the CPU; and the mesh paths the dry run repaired for the
recurrent families (the scans and the WKV step on each rank's shards),
held on a real 4-rank gloo mesh against the single-device run."""
import os

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced
from repro_torch.launch import dryrun

torch.set_num_threads(1)


def _reference_dryrun():
    """The reference's module, imported without letting the XLA_FLAGS it
    sets at import (512 host devices) reach a later JAX start here."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def _ref_cfg(arch):
    from repro.configs import get_config as jget_config
    return jget_config(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_analytic_numbers_equal_the_references(arch, shape):
    ref = _reference_dryrun()
    from repro.configs import SHAPES as JSHAPES
    cfg, jcfg = get_config(arch), _ref_cfg(arch)
    assert dryrun.model_flops_for(cfg, SHAPES[shape]) \
        == ref.model_flops_for(jcfg, JSHAPES[shape])
    for n in (256, 512):
        assert dryrun.analytic_device_bytes(cfg, SHAPES[shape], n) \
            == ref.analytic_device_bytes(jcfg, JSHAPES[shape], n)


# the keys of the reference's record for a pair that passes
# (src/repro/launch/dryrun.py run_one)
REF_KEYS = {
    "arch", "shape", "mesh", "n_chips", "status", "opt_sharding",
    "t_lower_s", "t_compile_s", "hlo_flops_per_device",
    "hlo_dot_bytes_per_device", "hlo_dot_bytes_flash_per_device",
    "memory_s_flash", "dominant_flash", "collective_bytes_per_device",
    "collective_by_kind", "collective_counts", "raw_cost_analysis_flops",
    "raw_cost_analysis_bytes", "memory_analysis", "analytic_device_memory",
    "model_flops", "roofline", "long_500k_variant"}
ROOF_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
             "useful_flops_ratio", "step_time_s"}


@pytest.mark.parametrize("arch,shape,kernel", [
    ("phi3-mini-3.8b", "train_4k", None),
    ("zamba2-2.7b", "prefill_32k", "mamba_ssd_scan"),
    ("rwkv6-7b", "prefill_32k", "wkv6_chunked"),
    ("phi3-mini-3.8b", "prefill_32k", "flash_attention"),
    ("granite-moe-3b-a800m", "decode_32k", "flash_decode"),
])
def test_run_one_on_a_small_fake_mesh(arch, shape, kernel):
    """A reduced config of each step kind on a (2, 2) mesh of 4 fake
    ranks: status ok, every key of the reference's record, the per-rank
    counts positive and the kernel of the path counted by its formula."""
    cfg = reduced(get_config(arch), layers=2)
    with dryrun.fake_world(4):
        from repro_torch.launch.mesh import _mesh
        mesh = _mesh((2, 2), ("data", "model"), "cpu")
        rec = dryrun.run_one(arch, shape, mesh=mesh, cfg=cfg, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert REF_KEYS <= set(rec)
    assert set(rec["roofline"]) == ROOF_KEYS
    assert rec["mesh"] == "mesh2x2" and rec["n_chips"] == 4
    assert rec["hlo_flops_per_device"] > 0
    assert rec["hlo_dot_bytes_flash_per_device"] \
        <= rec["hlo_dot_bytes_per_device"]
    assert rec["t_compile_s"] is None and rec["notes"]
    assert rec["memory_analysis"]["argument_gb"] > 0
    if kernel is None:
        assert rec["kernels"] == {}
        assert rec["collective_bytes_per_device"] > 0
    else:
        assert rec["kernels"][kernel]["launches"] > 0


def test_main_granite_decode_on_both_meshes(capsys):
    """The reference test's combination (tests/test_spmd.py
    test_dryrun_single_combo) on 256 and then 512 fake ranks."""
    dryrun.main(["--device", "cpu", "--arch", "granite-moe-3b-a800m",
                 "--shape", "decode_32k", "--both-meshes", "--out", ""])
    out = capsys.readouterr().out
    assert "[OK] granite-moe-3b-a800m x decode_32k x pod16x16" in out
    assert "[OK] granite-moe-3b-a800m x decode_32k x pod2x16x16" in out
    assert out.rstrip().endswith("all dry-runs passed")


def test_main_refuses_a_second_group():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=2)
    try:
        with pytest.raises(RuntimeError, match="owns its process"):
            dryrun.main(["--device", "cpu", "--arch", "phi3-mini-3.8b",
                         "--shape", "decode_32k", "--out", ""])
    finally:
        dist.destroy_process_group()


# the recurrent families on a real mesh: 4 gloo ranks, (2, 2).  The mesh
# step sums in other orders (gradients of the shared decays across
# ranks), so f32 values agree to a band, not to the bit
MESH_BAND = 2e-5


def _recurrent_mesh_worker(rank, world, port, path):
    import json

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    from repro_torch import models
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (batch_spec, cache_specs,
                                             distribute_tree, param_specs)
    from repro_torch.models.shard_ctx import replicated_ops
    mesh = make_host_mesh(world, device="cpu")
    out = {}
    for arch, layers in (("rwkv6-7b", 2), ("zamba2-2.7b", 6)):
        cfg = reduced(get_config(arch), layers=layers, n_heads=4)
        gen = torch.Generator().manual_seed(0)
        params = models.init_params(cfg, gen, device="cpu")
        tok = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                            dtype=torch.int32)

        def loss_grads(p, b):
            leaves, treedef = tree_flatten(p)
            xs = [x.detach().float().requires_grad_() for x in leaves]
            loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, b)
            return loss, torch.autograd.grad(loss, xs)

        def place(t):
            return distribute_tree(t, batch_spec(tuple(t.shape), mesh), mesh)
        loss0, g0 = loss_grads(params, {"tokens": tok, "labels": tok})
        cache = models.init_cache(cfg, 4, 8, device="cpu")
        want, _ = models.decode_step(params, cfg, cache, tok[:, :1], 0)
        dp = distribute_tree(params, param_specs(params, mesh), mesh)
        cache = models.init_cache(cfg, 4, 8, device="cpu")
        dc = distribute_tree(cache, cache_specs(cache, mesh, batch=4), mesh)
        with replicated_ops():
            loss1, g1 = loss_grads(dp, {"tokens": place(tok),
                                        "labels": place(tok)})
            got, _ = models.decode_step(dp, cfg, dc, place(tok[:, :1]), 0)
        out[arch] = {
            "loss": abs(float(loss0) - float(loss1.detach())),
            "grads": max(float((a - b.full_tensor()).abs().max())
                         for a, b in zip(g0, g1)),
            "decode": float((want - got.full_tensor()).abs().max())}
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()


def test_recurrent_families_on_a_gloo_mesh_match_single_device(tmp_path):
    """Reduced rwkv6-7b and zamba2-2.7b (f32) on a (2, 2) mesh of 4 gloo
    ranks: the loss, every gradient and one decode step's logits against
    the single-device run, within MESH_BAND.  The scans and the WKV step
    run on each rank's batch rows and heads (``on_rank_shards``), their
    shared decays taking the sum of the ranks' gradients."""
    import json
    import socket

    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = str(tmp_path / "out.json")
    mp.spawn(_recurrent_mesh_worker, args=(4, port, path), nprocs=4,
             join=True)
    with open(path) as f:
        out = json.load(f)
    for arch, gaps in out.items():
        assert max(gaps.values()) < MESH_BAND, (arch, gaps)
