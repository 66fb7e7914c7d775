"""SPMD dual-batch training on a device mesh (the port of the reference's
``examples/dual_batch_spmd.py``): a thin front end over
``repro_torch.engine``.  The paper's contribution-scaled merge runs as
one weighted loss whose sums DTensor reduces across the mesh (params,
optimizer state and batches placed by ``launch.sharding``), and the
fused server update (B2) runs once per leaf on its local shard.

  python -m repro_torch.examples.dual_batch_spmd               # one NCCL rank on the card
  python -m repro_torch.examples.dual_batch_spmd --device cpu  # 8 gloo CPU ranks, (4, 2) mesh

Without ``--device`` it runs on the card, and refuses when CUDA is
absent.  The CPU form spawns its ranks itself (a file rendezvous in a
temporary directory, a timeout on every collective) and waits for them
all.
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# the example's schedule: the reference's plan, phase and optimizer
PLAN = dict(B_L=64, d=4096, n_workers=4, n_small=3, k=1.05)
SEQ, GLOBAL_BATCH, LR, STEPS = 64, 16, 0.01, 10
TIMEOUT_S = 300


def example_plan():
    from repro_torch.core import LinearTimeModel, solve_plan
    return solve_plan(LinearTimeModel(a=1.0, b=24.57), **PLAN)


def example_phases(n_steps: int = STEPS):
    from repro_torch.engine import single_phase
    return single_phase(input_size=SEQ, n_steps=n_steps, lr=LR,
                        batch_size=GLOBAL_BATCH, plan=example_plan())


DATA_VOCAB = 512        # the reduced configs' whole vocabulary


def example_plane(cfg):
    """The example's data: tokens below ``min(vocab, DATA_VOCAB)`` (the
    synthetic source keeps a vocab x vocab f64 Markov table per class:
    66 GB at phi3-mini's 32064)."""
    from repro_torch.data import DataPlane, SyntheticTokens
    return DataPlane(SyntheticTokens(vocab=min(cfg.vocab_size, DATA_VOCAB),
                                     seed=1, n_examples=1024), seed=1)


def run_example(cfg, mesh=None, *, device=None, optimizer=None,
                fused_merge="auto", n_steps: int = STEPS, params=None,
                log_every: int = 3, log_fn=None, **engine_kw):
    """The example's schedule through ``SpmdBackend``, on ``mesh`` (or
    without one, on ``device``); params drawn from seed 0 on the device
    unless given.  ``engine_kw`` goes to ``TrainEngine`` (e.g.
    ``scan_loop=False``).  Returns the ``RunResult`` (on a mesh, params
    as DTensors)."""
    from repro_torch import models
    from repro_torch.engine import SpmdBackend, TrainEngine
    from repro_torch.optim import sgd_momentum
    dev = mesh.device_type if mesh is not None else device
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = models.init_params(cfg, gen, device=dev)
    engine = TrainEngine(cfg, optimizer or sgd_momentum(0.9), mesh=mesh,
                         fused_merge=fused_merge, device=device,
                         **engine_kw)
    plane = example_plane(cfg)
    try:
        return SpmdBackend(engine, plane).run(
            example_phases(n_steps), params, log_every=log_every,
            log_fn=log_fn)
    finally:
        plane.close()


def _example(device: str, n_steps: int) -> None:
    """The reference's script, on the process group this rank joined."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import dbl_merge as dm
    from repro_torch.kernels.ops import dbl_merge
    from torch.distributed.device_mesh import init_device_mesh
    rank0 = dist.get_rank() == 0
    world = dist.get_world_size()
    model = 2 if world % 2 == 0 else 1          # the reference's (4, 2)
    mesh = init_device_mesh(device, (world // model, model),
                            mesh_dim_names=("data", "model"))
    cfg = reduced(get_config("phi3-mini-3.8b"))
    plan = example_plan()
    layout = example_phases(n_steps)[0].layout
    if rank0:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{mesh.device_type}")
        print(f"plan: B_S={plan.B_S} factor={plan.update_factor_small:.3f};"
              f" SPMD weights = {layout.weights().tolist()}")
    res = run_example(cfg, mesh, n_steps=n_steps)
    if rank0:
        for h in res.history:
            print(f"step {h['step']}: loss {h['loss']:.4f}")
        print(f"backend={res.backend} phases={res.phases}")

    # the fused server update (paper Eq. update), one B2 launch per leaf
    # on each rank's shard
    params = res.params
    g_large = tree_map(torch.ones_like, params)
    g_small = tree_map(lambda p: 0.5 * torch.ones_like(p), params)
    dm.reset_counts()
    dbl_merge(params, g_large, g_small, factor=plan.update_factor_small,
              lr=0.01, leafwise=True)
    runs = dm.launch_count("dbl_merge_flat2d") + dm.plain_count(
        "dbl_merge_flat2d")
    if rank0:
        print("dbl_merge applied leafwise:", len(tree_leaves(params)),
              f"leaves updated in {runs} B2 runs on rank 0")


def _rank(rank: int, world: int, init: str, device: str,
          n_steps: int) -> None:
    torch.set_num_threads(1)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        _example(device, n_steps)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks; default: the card")
    ap.add_argument("--ranks", type=int, default=8,
                    help="gloo ranks on the CPU (the card runs one)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device).type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no process group for {dev}: 'cpu' or 'cuda'")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        if dev == "cuda":
            _rank(0, 1, init, "cuda", args.steps)
            return
        import torch.multiprocessing as mp
        mp.start_processes(_rank, args=(args.ranks, init, "cpu", args.steps),
                           nprocs=args.ranks, start_method="spawn")


if __name__ == "__main__":
    main()
