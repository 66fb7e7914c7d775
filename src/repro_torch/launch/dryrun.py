"""Multi-pod dry run: every (arch x input shape) step on the production
meshes, counted on one rank, with the card's roofline terms (the port of
the reference's ``launch/dryrun.py``).

The reference lowers and compiles each step for 256 (or 512) fake XLA
devices and reads the compiled module.  The port runs each step once,
eagerly, on the parameter, input and cache trees of ``launch/specs.py``
(meta tensors: no storage) placed as DTensors on a production mesh
(``launch/mesh.py``) over a fake process group of 256 ranks, or 512
with ``--multi-pod``, whose collectives move nothing.  The run happens on
rank 0's shards, under ``launch/hlo_analysis.py``'s counter, which
counts that rank's products, gathers and collectives; the kernels on the
path (B4, B5, B7, B8) stand in on meta tensors and add their own work
by the formulas beside their wrappers.

Each record has the reference's keys.  ``t_lower_s`` is the time of
the counted run (the trace); ``t_compile_s``, ``raw_cost_analysis_*``
and ``memory_analysis``'s ``temp_gb`` and ``alias_gb`` are null, and
``notes`` says why; ``argument_gb`` and ``output_gb`` are rank 0's local
shards.  Two keys are the port's own: ``collective_by_axis`` (the
roofline prices each mesh axis at the slowest link it crosses) and
``kernels`` (each kernel's meta launches, FLOPs and bytes).  The counts
follow the sharding DTensor's propagation picks, which differs between
PyTorch releases.

``main`` owns its process: it starts the fake group (as the reference
sets ``XLA_FLAGS`` before any import), builds the mesh with
``make_production_mesh`` and destroys the group at the end; with
``--both-meshes`` one group after the other.  ``--device`` names the
mesh's device type: the card by default, ``cpu`` for a CPU host (the
tensors are meta either way).  Without CUDA and without ``--device cpu``
it raises, as every entry point of the port does.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
  python -m repro_torch.launch.dryrun --device cpu --arch \\
      granite-moe-3b-a800m --shape decode_32k --both-meshes --out ""
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import torch

from repro_torch import models
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device
from repro_torch.launch.hlo_analysis import (CostCounter, mesh_axis_bandwidth,
                                             roofline_terms)
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.launch.sharding import (batch_spec, batch_specs,
                                         cache_specs, distribute_tree,
                                         param_specs)
from repro_torch.launch.specs import META, abstract_params, input_specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, with_window_override)
from repro_torch.optim import sgd_momentum

NOTES = ("t_lower_s is the time of the counted eager run of the step (no "
         "lowering: nothing is compiled); t_compile_s and raw_cost_analysis_"
         "* are null, as there is no compiled module to ask; temp_gb is null: "
         "DTensor's sharding propagation makes meta tensors of global shapes "
         "through the same dispatcher as the step's own local tensors, so a "
         "tracker of live local bytes cannot tell the two apart.")


def model_flops_for(cfg, shape) -> float:
    """Global 6·N_active·D (train) / 2·N_active·D (inference) model FLOPs."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analytic_device_bytes(cfg, shape, n_chips: int) -> dict:
    """Device-memory estimate per card (H100 80GB HBM3): params,
    optimizer state and gradients sharded over the mesh; the cache
    sharded."""
    pbytes = 2 if cfg.param_dtype == "bfloat16" else 4
    n = cfg.param_count()
    params = n * pbytes / n_chips
    out = {"params_gb": params / 1e9}
    if shape.kind == "train":
        out["opt_state_gb"] = n * 4 / n_chips / 1e9      # f32 momentum
        out["grads_gb"] = params / 1e9
        tokens_local = shape.global_batch * shape.seq_len / n_chips * 16
        # checkpointed activations: one (tokens_local, d_model) bf16 per layer
        out["act_ckpt_gb"] = (cfg.n_layers + cfg.encoder_layers) \
            * tokens_local * cfg.d_model * 2 / 16 / 1e9
    if shape.kind == "decode":
        kv_layers = sum(1 for k in cfg.blocks if "attn" in k) \
            + (cfg.n_layers if cfg.encoder_layers else 0)
        cache = (kv_layers * shape.global_batch * shape.seq_len
                 * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
        out["kv_cache_gb"] = cache / n_chips / 1e9
    return out


def build_step(cfg, shape, mesh):
    """(step, args): the shape's step and its arguments placed on
    ``mesh`` as DTensors of meta shards (the counterpart of the
    reference's ``build_jitted``)."""
    specs = input_specs(cfg, shape)
    aparams = abstract_params(cfg)
    pspecs = param_specs(aparams, mesh)
    params = distribute_tree(aparams, pspecs, mesh)
    tok_of = lambda t: distribute_tree(t, batch_spec(tuple(t.shape), mesh),
                                       mesh)

    if shape.kind == "train":
        opt = sgd_momentum(0.9)
        # the momentum as the reference's eval_shape of opt.init gives it
        # (the params' dtypes), placed by the param specs
        aopt = {"v": tree_map(lambda p: torch.empty(
            p.shape, dtype=p.dtype, device=META), aparams)}
        opt_state = distribute_tree(aopt, {"v": pspecs}, mesh)
        batch = distribute_tree(specs["batch"],
                                batch_specs(specs["batch"], mesh), mesh)
        return make_train_step(cfg, opt), (params, opt_state, batch, 0.01)
    if shape.kind == "prefill":
        args = [params, tok_of(specs["tokens"])]
        if cfg.encoder_layers:
            args.append(tok_of(specs["frames"]))
        return make_prefill_step(cfg), tuple(args)
    # decode
    cfg2 = with_window_override(cfg, shape)
    cache = models.init_cache(cfg2, shape.global_batch, shape.seq_len,
                              device=META)
    cache = distribute_tree(cache, cache_specs(cache, mesh,
                                               batch=shape.global_batch),
                            mesh)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return make_decode_step(cfg, shape), (params, cache,
                                          tok_of(specs["tokens"]), pos)


def _local_bytes(tree) -> int:
    from repro_torch.core.dtensor import local
    return sum(local(t).numel() * local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _run_counted(step, args, mesh, opt_sharding: bool):
    from repro_torch.models.shard_ctx import activation_sharding, \
        replicated_ops
    act = (activation_sharding(mesh, data_axes=data_axes(mesh))
           if opt_sharding else contextlib.nullcontext())
    with act, replicated_ops(), CostCounter(mesh) as counter:
        out = step(*args)
    return counter.cost, out


def _mesh_name(mesh) -> str:
    shape = tuple(mesh.shape)
    return {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}.get(
        shape, "mesh" + "x".join(map(str, shape)))


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str = "", verbose: bool = True,
            opt_sharding: bool = False, remat: str = "",
            pad_experts: int = 0, moe_group: int = 0, moe_cf: float = 0.0,
            pad_heads: int = 0, mesh=None, cfg=None,
            device=None) -> dict:
    """One (arch x shape) step on ``mesh`` (by default the production
    mesh of ``multi_pod`` over the current process group, on ``device``:
    the card unless the caller names another), counted on this rank;
    returns the reference's record.  ``cfg`` replaces
    ``get_config(arch)`` (a reduced config, say).  A failure is recorded
    with its error, not raised."""
    cfg = cfg or get_config(arch)
    if remat:
        cfg = replace(cfg, remat=remat)
    if pad_experts and cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, pad_to=pad_experts))
    if moe_group and cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, dispatch_group=moe_group))
    if moe_cf and cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=moe_cf))
    if pad_heads:
        # structural variant for the sharding study: padded q-heads carry
        # zeroed wo rows in production (semantics-preserving)
        cfg = replace(cfg, n_heads=pad_heads)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_chips = mesh.size()
    mesh_name = _mesh_name(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_chips": n_chips, "status": "ok",
           "opt_sharding": opt_sharding}
    try:
        step, args = build_step(cfg, shape, mesh)
        t0 = time.time()
        cost, out = _run_counted(step, args, mesh, opt_sharding)
        t_trace = time.time() - t0
        mf = model_flops_for(cfg, shape)
        axis_bw = mesh_axis_bandwidth(mesh)
        kw = dict(per_device_flops=cost.flops,
                  per_device_collective_bytes=cost.collective_bytes,
                  n_chips=n_chips, model_flops=mf,
                  collective_by_axis=cost.collective_by_axis,
                  axis_bw=axis_bw)
        roof = roofline_terms(per_device_bytes=cost.dot_bytes, **kw)
        roof_flash = roofline_terms(per_device_bytes=cost.dot_bytes_flash,
                                    **kw)
        arg_b = _local_bytes(args)
        rec.update({
            "t_lower_s": round(t_trace, 1),
            "t_compile_s": None,
            "hlo_flops_per_device": cost.flops,
            "hlo_dot_bytes_per_device": cost.dot_bytes,
            "hlo_dot_bytes_flash_per_device": cost.dot_bytes_flash,
            "memory_s_flash": roof_flash.memory_s,
            "dominant_flash": roof_flash.dominant,
            "collective_bytes_per_device": cost.collective_bytes,
            "collective_by_kind": cost.collective_by_kind,
            "collective_counts": cost.collective_counts,
            "collective_by_axis": cost.collective_by_axis,
            "kernels": cost.kernels,
            "raw_cost_analysis_flops": None,
            "raw_cost_analysis_bytes": None,
            "memory_analysis": {
                "argument_gb": arg_b / 1e9,
                "output_gb": _local_bytes(out) / 1e9,
                "temp_gb": None,
                "alias_gb": None,
            },
            "analytic_device_memory": analytic_device_bytes(cfg, shape,
                                                            n_chips),
            "model_flops": mf,
            "roofline": {
                "compute_s": roof.compute_s,
                "memory_s": roof.memory_s,
                "collective_s": roof.collective_s,
                "dominant": roof.dominant,
                "useful_flops_ratio": roof.useful_flops_ratio,
                "step_time_s": roof.step_time_s,
            },
            "long_500k_variant": (
                "window" if shape_name == "long_500k"
                and cfg.long_context_mode == "window" else "native"),
            "notes": NOTES,
        })
        if verbose:
            print(f"[OK] {arch} x {shape_name} x {mesh_name}: "
                  f"trace {t_trace:.1f}s  "
                  f"flops/dev {cost.flops:.2e}  "
                  f"coll/dev {cost.collective_bytes:.2e}B  "
                  f"dominant={roof.dominant}", flush=True)
            print(f"     memory: args {arg_b / 1e9:.2f} GB (local shards)",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {e}",
                  flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(out_dir,
                             f"{arch}__{shape_name}__{mesh_name}.json")
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process (rank 0): its
    collectives move nothing.  Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run owns its process: a process group "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-sharding", action="store_true",
                    help="enable activation sharding constraints")
    ap.add_argument("--remat", default="", choices=("", "none", "block",
                                                    "dots"),
                    help="override the config's remat policy")
    ap.add_argument("--pad-experts", type=int, default=0,
                    help="pad MoE expert count for expert-parallel")
    ap.add_argument("--moe-group", type=int, default=0,
                    help="override MoE dispatch group size")
    ap.add_argument("--moe-cf", type=float, default=0.0,
                    help="override MoE capacity factor")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad attention heads to divide the TP axis")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--device", default=None,
                    help="the mesh's device (default: the card); the "
                         "tensors are meta either way")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for mp in meshes:
        with fake_world(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp, device=device)
            for arch in archs:
                for shape in shapes:
                    rec = run_one(arch, shape, multi_pod=mp, out_dir=args.out,
                                  opt_sharding=args.opt_sharding,
                                  remat=args.remat,
                                  pad_experts=args.pad_experts,
                                  moe_group=args.moe_group,
                                  moe_cf=args.moe_cf,
                                  pad_heads=args.pad_heads, mesh=mesh)
                    n_fail += rec["status"] != "ok"
    if n_fail:
        print(f"{n_fail} combinations FAILED", file=sys.stderr)
        sys.exit(1)
    print("all dry-runs passed")


if __name__ == "__main__":
    main()
