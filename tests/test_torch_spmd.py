"""SPMD on ``torch.distributed`` (``repro_torch.launch.mesh`` /
``launch.sharding`` / ``models.shard_ctx``, ``TrainEngine(mesh=...)`` and
B2's leafwise form) against the reference.

Eight gloo ranks on the CPU form the reference's ``(4, 2)`` mesh
``("data", "model")``.  They are spawned once for the module (each rank
runs this file as a script, ``_rank_main``), run every sharded case, and
leave their results in a work directory; each test reads its case there.
Every sharded run is held both to the port's single-process run and to
the reference's single-device jitted run, computed here in the pytest
process while the ranks work:

* the weighted dual-batch loss on reduced phi3-mini (``LOSS_BAND``, the
  reference test's 1e-4);
* ``make_train_step`` with ``sgd_momentum(0.9)`` on reduced granite: the
  loss within ``LOSS_BAND``, params within ``PARAM_BAND`` (the reference
  test's 1e-3), and each rank's local shards exactly the slices of the
  gathered result its placements name, on the placements
  ``param_specs`` gives;
* reduced gemma3-4b (``n_heads=4``) under ``activation_sharding``: equal
  to the unconstrained forward within ``LOSS_BAND`` (held to the
  single-device forward: the reference's constrained run fails under this
  jax, ROADMAP C1);
* ``TrainEngine(mesh=...)`` through ``SpmdBackend`` on the example's
  plan and phase (4 steps), fused (B2 leafwise, plain form here) and
  weighted (``sgd_momentum(0.9)``) on phi3, fused on granite, against
  the non-mesh per-step runs (``ENGINE_BAND``) and the reference's
  engine; its checkpoint holds the full tree, the same arrays as a
  non-mesh save of the same values;
* the leafwise ``dbl_merge`` bit-equal to the flat form, on sharded and
  replicated DTensor trees;
* the engine's refusals of server momentum and bf16 with a mesh;
* planted faults, each outside its band: (a) per-rank denominators of the
  weighted loss, (b) MoE dispatch groups of each rank's tokens (capacity
  and drops per rank), and in the engine's fused step a small group
  padded to the data ranks with weight-0 rows, (c) the load-balance aux
  loss as a mean of per-rank products.

Each rank runs one torch thread (ROADMAP C5); every collective and the
spawn have a timeout, so a hung rank fails the module instead of the
suite.
"""
import datetime
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

WORLD = 8
MESH_SHAPE = (4, 2)
AXES = ("data", "model")
SPAWN_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 240
LOSS_BAND = 1e-4
PARAM_BAND = 1e-3
AUX_BAND = 1e-5
# sharded vs unsharded engine runs: the same math, sums in another order
ENGINE_BAND = {"loss": 1.5e-4, "params": 1e-5}
ENGINE_STEPS = 4
# the engine's mesh runs: phi3 fused and weighted, granite fused (an MoE
# model: its dispatch sees every row of a group), and granite with the
# planted padded group
ENGINE_FORMS = ("fused", "weighted", "granite_fused", "granite_padded")
# the reference tests' inputs
PHI3_BATCH = (16, 32)
GRANITE_BATCH = (8, 16)
GEMMA_BATCH = (8, 32)
TRAIN_LR = 0.05
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


# ====================================================== the ranks' side
def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _fault_weighted_loss(params, cfg, batch):
    """Planted fault (a): the weighted loss with each rank's own
    denominator — ``sum(per_ex * w) / sum(w)`` over the rank's rows."""
    from repro_torch import models
    _, aux = models.loss_fn(params, cfg, batch)
    per_ex = aux["per_example"]
    w = batch["weight"]
    return float((per_ex * w).to_local().sum() / w.to_local().sum())


def _per_rank_aux(dsize):
    """Planted fault (c): the load-balance loss as the mean over data
    ranks of each rank's ``E * sum_e f_e * p_e`` on its own tokens."""
    from repro_torch.models import moe

    def aux(probs, top1_idx, num_experts):
        parts = zip(_full(probs).chunk(dsize, dim=0),
                    _full(top1_idx).chunk(dsize, dim=0))
        vals = [moe._one_hot(i, num_experts).mean(0).mul(p.mean(0)).sum()
                * num_experts for p, i in parts]
        return torch.stack(vals).mean()
    return aux


def _padded_group(batch, keys, idx):
    """Planted fault (b) in the fused step: a group whose rows the data
    axis does not divide padded to a multiple of its ranks with weight-0
    copies of its first rows (placed whole, so that only the padding
    differs).  Weight 0 takes a row out of the cross-entropy mean, but in
    an MoE layer the padded rows still join the dispatch: the group
    size, the capacity, the expert queues and the aux mean all change."""
    from repro_torch.launch.sharding import distribute_tree
    mesh = batch[keys[0]].device_mesh
    n, ranks = len(idx), mesh["data"].size()
    pad = -n % ranks
    idx = torch.cat([idx, idx[:pad]])
    rows = {k: batch[k].full_tensor().index_select(0, idx) for k in keys}
    rows["weight"] = torch.cat([torch.ones(n), torch.zeros(pad)])
    return distribute_tree(rows, {k: (None,) * v.dim()
                                  for k, v in rows.items()}, mesh)


def _case_weighted_loss(mesh, w):
    from repro_torch import models
    from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                             param_specs)
    from repro_torch.models.shard_ctx import replicated_ops
    cfg, params, batch = w["phi3_cfg"], w["phi3_params"], w["phi3_batch"]
    dp = distribute_tree(params, param_specs(params, mesh), mesh)
    db = distribute_tree(batch, batch_specs(batch, mesh), mesh)
    with replicated_ops():
        loss, _ = models.loss_fn(dp, cfg, db)
        fault = _fault_weighted_loss(dp, cfg, db)
    return {"loss": float(_full(loss)), "fault_loss": fault}


def _case_train_step(mesh, w, work, rank):
    from repro_torch import models
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                             param_specs, placements,
                                             spec_leaves)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe
    from repro_torch.models.shard_ctx import replicated_ops
    from repro_torch.optim import sgd_momentum
    cfg, params, batch = w["granite_cfg"], w["granite_params"], \
        w["granite_batch"]
    opt = sgd_momentum(0.9)
    specs = param_specs(params, mesh)
    dp = distribute_tree(params, specs, mesh)
    state0 = opt.init(params)
    state = distribute_tree(state0, param_specs(state0, mesh), mesh)
    db = distribute_tree(batch, batch_specs(batch, mesh), mesh)
    with replicated_ops():
        p1, s1, loss = make_train_step(cfg, opt)(dp, state, db, TRAIN_LR)
        _, aux = models.forward(dp, cfg, db["tokens"], return_aux=True,
                                train=True)
        # (b): dispatch groups of each data rank's tokens
        dsize = mesh.shape[0]
        tokens = batch["tokens"].numel()
        pcfg = replace(cfg, moe=replace(cfg.moe,
                                        dispatch_group=tokens // dsize))
        fault_b, _ = models.loss_fn(dp, pcfg, db)
        # (c): the aux loss as a mean of per-rank products
        real = moe.load_balance_loss
        moe.load_balance_loss = _per_rank_aux(dsize)
        try:
            _, fault_c = models.forward(dp, cfg, db["tokens"],
                                        return_aux=True, train=True)
        finally:
            moe.load_balance_loss = real
    want = [placements(s, mesh) for s in spec_leaves(params, specs)]
    leaves = tree_leaves(p1)
    vel = tree_leaves(s1["v"])
    torch.save({"params": [l.to_local() for l in leaves],
                "v": [v.to_local() for v in vel],
                "placements": [_kinds(l.placements) for l in leaves],
                "v_placements": [_kinds(v.placements) for v in vel],
                "want": [_kinds(p) for p in want]},
               os.path.join(work, f"local{rank}.pt"))
    full = [_full(l) for l in leaves]
    return {"loss": float(_full(loss)), "aux": float(_full(aux)),
            "fault_b_loss": float(_full(fault_b)),
            "fault_c_aux": float(_full(fault_c)), "params": full}


def _kinds(placements):
    """Placements as ("S", dim) / ("R", None) pairs."""
    return [("S", p.dim) if p.is_shard() else ("R", None)
            for p in placements]


def _case_gemma_forward(mesh, w):
    from repro_torch import models
    from repro_torch.launch.sharding import (batch_spec, distribute_tree,
                                             param_specs)
    from repro_torch.models.shard_ctx import activation_sharding, \
        replicated_ops
    cfg, params, tok = w["gemma_cfg"], w["gemma_params"], w["gemma_tokens"]
    dp = distribute_tree(params, param_specs(params, mesh), mesh)
    dt = distribute_tree({"t": tok}, {"t": batch_spec(tok.shape, mesh)},
                         mesh)["t"]
    with replicated_ops():
        free = models.forward(dp, cfg, dt)
        with activation_sharding(mesh):
            constrained = models.forward(dp, cfg, dt)
    out = {"free": _full(free), "constrained": _full(constrained)}
    # granite: the MoE layer's three constrain_first calls (4 experts on
    # the model axis of 2)
    cfg, params = w["granite_cfg"], w["granite_params"]
    tok = w["granite_batch"]["tokens"]
    dp = distribute_tree(params, param_specs(params, mesh), mesh)
    dt = distribute_tree({"t": tok}, {"t": batch_spec(tok.shape, mesh)},
                         mesh)["t"]
    with replicated_ops():
        free, faux = models.forward(dp, cfg, dt, return_aux=True)
        with activation_sharding(mesh):
            cons, caux = models.forward(dp, cfg, dt, return_aux=True)
    out["moe_gap"] = float((_full(free) - _full(cons)).abs().max())
    out["moe_aux_gap"] = abs(float(_full(faux)) - float(_full(caux)))
    return out


def _case_constrain(mesh):
    """The placements ``constrain`` / ``constrain_first`` give, and their
    no-ops."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.models.shard_ctx import (activation_sharding,
                                              constrain, constrain_first)
    rep = [Replicate(), Replicate()]
    x = distribute_tensor(torch.arange(8 * 4 * 6 * 2.).reshape(8, 4, 6, 2),
                          mesh, rep)
    xe = distribute_tensor(torch.ones(4, 5, 3, 6), mesh, rep)
    out = {"outside": str(tuple(constrain(x, "b.h.").placements))}
    loc = x.to_local()
    with activation_sharding(mesh):
        c = constrain(x, "b.h.")
        out.update(
            bh=str(tuple(c.placements)),
            values_kept=bool(torch.equal(c.full_tensor(), x.full_tensor())),
            undivided=str(tuple(constrain(x, "bmh.").placements)),
            first_fallback=str(tuple(constrain_first(
                xe, ["bh..", "b..m"]).placements)),
            plain_is_noop=constrain(loc, "b.h.") is loc)
    return out


def _case_engine(mesh, w, work):
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.core.tree import tree_leaves
    from repro_torch.examples.dual_batch_spmd import run_example
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.optim import sgd_momentum
    from repro_torch.engine import steps
    out = {}
    for form in ENGINE_FORMS:
        arch = "granite" if form.startswith("granite") else "phi3"
        cfg, params = w[f"{arch}_cfg"], w[f"{arch}_params"]
        K.reset_counts()
        kw = ({} if form == "weighted"
              else dict(optimizer=sgd_momentum(0.0), fused_merge=True))
        keep = steps._mesh_group
        if form == "granite_padded":
            steps._mesh_group = _padded_group
        try:
            res = run_example(cfg, mesh, params=params,
                              n_steps=ENGINE_STEPS, log_every=1, **kw)
        finally:
            steps._mesh_group = keep
        leaves = tree_leaves(res.params)
        out[form] = {
            "losses": [h["loss"] for h in res.history],
            "params": [_full(l) for l in leaves],
            "dtensor": all(hasattr(l, "placements") for l in leaves),
            "b2_plain": K.plain_count("dbl_merge_flat2d"),
            "b1_plain": K.plain_count("dbl_apply_flat2d"),
            "launches": K.launch_count(), "leaves": len(leaves)}
    # the checkpoint of a mesh run: rank 0 writes the full tree; beside it
    # a non-mesh save of the same values
    from repro_torch.engine import SpmdBackend, TrainEngine
    from repro_torch.examples.dual_batch_spmd import (example_phases,
                                                      example_plane)
    cfg, params = w["phi3_cfg"], w["phi3_params"]
    ck = os.path.join(work, "ckpt_mesh")
    eng = TrainEngine(cfg, sgd_momentum(0.9), mesh=mesh)
    res = SpmdBackend(eng, example_plane(cfg)).run(
        example_phases(1), params, ckpt_dir=ck, log_every=1)
    whole = {"params": [_full(l) for l in tree_leaves(res.params)],
             "opt_state": {"v": [_full(l) for l in
                                 tree_leaves(res.opt_state["v"])]}}
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    _, pdef = tree_flatten(params)
    if torch.distributed.get_rank() == 0:
        save_checkpoint(os.path.join(work, "ckpt_plain"), 1, {
            "params": tree_unflatten(pdef, whole["params"]),
            "opt_state": {"v": tree_unflatten(pdef,
                                              whole["opt_state"]["v"])}})
    return out


def _case_leafwise(mesh, w):
    """The leafwise dbl_merge on the sharded phi3 tree vs the flat form
    on the whole tree: every rank's shard bit-equal to its slice."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels.ops import dbl_merge
    from repro_torch.launch.sharding import distribute_tree, param_specs
    params = w["phi3_params"]
    gen = torch.Generator().manual_seed(3)
    gl = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    gs = tree_map(lambda p: torch.randn(p.shape, generator=gen), params)
    specs = param_specs(params, mesh)
    dp, dgl, dgs = (distribute_tree(t, specs, mesh)
                    for t in (tree_map(torch.clone, params), gl, gs))
    K.reset_counts()
    out = dbl_merge(dp, dgl, dgs, factor=0.9365079365079365, lr=0.01)
    runs = K.plain_count("dbl_merge_flat2d")
    flat = dbl_merge(tree_map(torch.clone, params), gl, gs,
                     factor=0.9365079365079365, lr=0.01, leafwise=False)
    gap = 0.0
    for d, f in zip(tree_leaves(out), tree_leaves(flat)):
        want = distribute_tensor(f, mesh, d.placements,
                                 src_data_rank=None).to_local()
        gap = max(gap, float((d.to_local() - want).abs().max()))
    # a fully replicated DTensor tree cannot ravel into one store either:
    # ``leafwise=None`` sends it leaf by leaf, and the flat form refuses it
    from torch.distributed.tensor import Replicate
    rep = [Replicate()] * mesh.ndim
    rp, rgl, rgs = (tree_map(lambda t: distribute_tensor(
        t, mesh, rep, src_data_rank=None), tr)
        for tr in (tree_map(torch.clone, params), gl, gs))
    K.reset_counts()
    rout = dbl_merge(rp, rgl, rgs, factor=0.9365079365079365, lr=0.01)
    rep_runs = K.plain_count("dbl_merge_flat2d")
    for d, f in zip(tree_leaves(rout), tree_leaves(flat)):
        gap = max(gap, float((d.to_local() - f).abs().max()))
    try:
        dbl_merge(rp, rgl, rgs, factor=0.9365079365079365, lr=0.01,
                  leafwise=False)
        flat_refusal = None
    except ValueError as e:
        flat_refusal = str(e)
    t = torch.tensor([gap])
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return {"gap": float(t), "runs": runs, "replicated_runs": rep_runs,
            "replicated_dtensor": all(hasattr(d, "placements")
                                      for d in tree_leaves(rout)),
            "flat_refusal": flat_refusal,
            "leaves": len(tree_leaves(params)),
            "in_place": all(a is b for a, b in zip(tree_leaves(out),
                                                    tree_leaves(dp)))}


def _case_meshes():
    """The port's mesh builders over this group of 8 ranks."""
    from repro_torch.launch.mesh import (data_axes, make_host_mesh,
                                         make_production_mesh)
    host = make_host_mesh(device="cpu")
    out = {"host": dict(zip(host.mesh_dim_names, host.shape)),
           "data_axes": data_axes(host)}
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
            out[f"production_{multi}"] = None
        except ValueError as e:
            out[f"production_{multi}"] = str(e)
    return out


def _case_refusals(mesh, w):
    from repro_torch.engine import TrainEngine
    from repro_torch.optim import sgd_momentum
    out = {}
    for name, kw in (("momentum", {"server_momentum": 0.9}),
                     ("bf16", {"precision": "bf16"})):
        try:
            TrainEngine(w["phi3_cfg"], sgd_momentum(0.9), mesh=mesh, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _rank_main(rank: int, world: int, init: str, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=AXES)
        w = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        res, times = {}, {}
        for name, fn in (
                ("weighted_loss", lambda: _case_weighted_loss(mesh, w)),
                ("train_step", lambda: _case_train_step(mesh, w, work,
                                                        rank)),
                ("gemma", lambda: _case_gemma_forward(mesh, w)),
                ("constrain", lambda: _case_constrain(mesh)),
                ("leafwise", lambda: _case_leafwise(mesh, w)),
                ("refusals", lambda: _case_refusals(mesh, w)),
                ("meshes", _case_meshes),
                ("engine", lambda: _case_engine(mesh, w, work))):
            t0 = time.perf_counter()
            res[name] = fn()
            times[name] = time.perf_counter() - t0
        res["seconds"] = times
        if rank == 0:
            torch.save(res, os.path.join(work, "spmd.pt"))
    finally:
        dist.destroy_process_group()


# ====================================================== the pytest side
from repro import models as jmodels                       # noqa: E402
from repro.configs import get_config as jget_config       # noqa: E402
from repro.configs import reduced as jreduced             # noqa: E402
from repro.core import LinearTimeModel as JLinearTimeModel  # noqa: E402
from repro.core import layout_from_plan as jlayout_from_plan  # noqa: E402
from repro.core import solve_plan as jsolve_plan          # noqa: E402
from repro.data import DataPlane as JDataPlane            # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.engine import SpmdBackend as JSpmdBackend      # noqa: E402
from repro.engine import TrainEngine as JTrainEngine      # noqa: E402
from repro.engine import single_phase as jsingle_phase    # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.optim import sgd_momentum as jsgd_momentum     # noqa: E402

from repro_torch import models                            # noqa: E402
from repro_torch.configs import get_config, reduced       # noqa: E402
from repro_torch.convert import lm_params_from_numpy      # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map   # noqa: E402
from repro_torch.examples import dual_batch_spmd as ex    # noqa: E402
from repro_torch.launch.steps import make_train_step      # noqa: E402
from repro_torch.optim import sgd_momentum                # noqa: E402


def _both(arch, **kw):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced config,
    the port's carried over from the reference's init."""
    jcfg = jreduced(jget_config(arch), **kw)
    cfg = reduced(get_config(arch), **kw)
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              "cpu")
    return cfg, jcfg, jp, tp


def _spawn(work):
    """Start the ranks; they run this file as a script."""
    init = "file://" + os.path.join(work, "rendezvous")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD), init,
         work], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]


def _wait(procs, deadline):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(i, p.returncode, o[-3000:]) for i, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad[0]


def _engine_refs(models_by_arch):
    """The example's schedule (4 steps) without a mesh: the port's
    per-step runs and the reference's, phi3 fused and weighted, granite
    fused."""
    out = {}
    jplan = jsolve_plan(JLinearTimeModel(a=1.0, b=24.57), **ex.PLAN)
    jphases = jsingle_phase(input_size=ex.SEQ, n_steps=ENGINE_STEPS,
                            lr=ex.LR, batch_size=ex.GLOBAL_BATCH, plan=jplan)
    for form in ("fused", "weighted", "granite_fused"):
        arch = "granite" if form.startswith("granite") else "phi3"
        cfg, jcfg, jp, tp = models_by_arch[arch]
        if form != "weighted":
            kw = dict(optimizer=sgd_momentum(0.0), fused_merge=True,
                      scan_loop=False)
            jeng = JTrainEngine(jcfg, jsgd_momentum(0.0), fused_merge=True,
                                scan_loop=False, interpret=True)
        else:
            kw = {}
            jeng = JTrainEngine(jcfg, jsgd_momentum(0.9))
        res = ex.run_example(cfg, device="cpu", n_steps=ENGINE_STEPS,
                             params=tree_map(torch.clone, tp), log_every=1,
                             **kw)
        jres = JSpmdBackend(jeng, JDataPlane(JSyntheticTokens(
            vocab=jcfg.vocab_size, seed=1, n_examples=1024), seed=1)).run(
            jphases, jax.tree_util.tree_map(jnp.copy, jp), log_every=1)
        out[form] = {
            "port": ([h["loss"] for h in res.history],
                     tree_leaves(res.params)),
            "ref": ([h["loss"] for h in jres.history],
                    [np.asarray(x) for x in
                     jax.tree_util.tree_leaves(jres.params)])}
    return out


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    """Spawn the ranks, compute the references meanwhile, then collect."""
    work = str(tmp_path_factory.mktemp("spmd"))
    torch.set_num_threads(1)
    t0 = time.time()
    phi3 = _both("phi3-mini-3.8b")
    granite = _both("granite-moe-3b-a800m")
    gemma = _both("gemma3-4b", n_heads=4)
    jplan = jsolve_plan(JLinearTimeModel(a=1.0, b=24.57), **ex.PLAN)
    weights = np.asarray(jlayout_from_plan(jplan, PHI3_BATCH[0]).weights(),
                         np.float32)
    ptok = _tokens(phi3[0].vocab_size, PHI3_BATCH, 1)
    gtok = _tokens(granite[0].vocab_size, GRANITE_BATCH, 1)
    etok = _tokens(gemma[0].vocab_size, GEMMA_BATCH, 1)
    t = lambda a: torch.from_numpy(a).long()
    inputs = {
        "phi3_cfg": phi3[0], "phi3_params": phi3[3],
        "phi3_batch": {"tokens": t(ptok), "labels": t(ptok),
                       "weight": torch.from_numpy(weights)},
        "granite_cfg": granite[0], "granite_params": granite[3],
        "granite_batch": {"tokens": t(gtok), "labels": t(gtok)},
        "gemma_cfg": gemma[0], "gemma_params": gemma[3],
        "gemma_tokens": t(etok)}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    procs = _spawn(work)
    try:
        ref = {}
        # the reference's single-device jitted results
        jb = {"tokens": jnp.asarray(ptok), "labels": jnp.asarray(ptok),
              "weight": jnp.asarray(weights)}
        ref["jax_weighted_loss"] = float(jax.jit(
            lambda p, b: jmodels.loss_fn(p, phi3[1], b)[0])(phi3[2], jb))
        jopt = jsgd_momentum(0.9)
        gb = {"tokens": jnp.asarray(gtok), "labels": jnp.asarray(gtok)}
        jp1, _, jl1 = jax.jit(jmake_train_step(granite[1], jopt))(
            jax.tree_util.tree_map(jnp.copy, granite[2]),
            jopt.init(granite[2]), gb, TRAIN_LR)
        ref["jax_train"] = (float(jl1), [np.asarray(x) for x in
                                         jax.tree_util.tree_leaves(jp1)])
        _, jaux = jax.jit(lambda p, x: jmodels.forward(
            p, granite[1], x, return_aux=True))(granite[2], gb["tokens"])
        ref["jax_aux"] = float(jaux)
        ref["jax_gemma"] = np.asarray(jax.jit(
            lambda p, x: jmodels.forward(p, gemma[1], x))(
            gemma[2], jnp.asarray(etok)))
        # the port in one process
        ref["port_weighted_loss"] = float(models.loss_fn(
            phi3[3], phi3[0], inputs["phi3_batch"])[0])
        opt = sgd_momentum(0.9)
        p1, s1, l1 = make_train_step(granite[0], opt)(
            tree_map(torch.clone, granite[3]), opt.init(granite[3]),
            inputs["granite_batch"], TRAIN_LR)
        ref["port_train"] = (float(l1), tree_leaves(p1),
                             tree_leaves(s1["v"]))
        ref["port_gemma"] = models.forward(gemma[3], gemma[0],
                                           inputs["gemma_tokens"])
        ref["engine"] = _engine_refs({"phi3": phi3, "granite": granite})
        ref_seconds = time.time() - t0
        _wait(procs, t0 + SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = torch.load(os.path.join(work, "spmd.pt"), weights_only=False)
    local = [torch.load(os.path.join(work, f"local{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    return {"res": res, "ref": ref, "local": local, "work": work,
            "inputs": inputs, "seconds": time.time() - t0,
            "ref_seconds": ref_seconds}


def _max_gap(a, b):
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


def test_weighted_dual_batch_loss_equals_single_device(spmd):
    """The paper's contribution-scaled merge is sharding-invariant: the
    weighted loss on the (4, 2) mesh equals the single-device one; the
    planted per-rank denominator (fault a) does not."""
    r, ref = spmd["res"]["weighted_loss"], spmd["ref"]
    assert abs(r["loss"] - ref["jax_weighted_loss"]) < LOSS_BAND
    assert abs(r["loss"] - ref["port_weighted_loss"]) < LOSS_BAND
    assert abs(r["fault_loss"] - ref["jax_weighted_loss"]) > LOSS_BAND


def test_train_step_matches_single_device(spmd):
    """``make_train_step`` with sgd_momentum(0.9) on reduced granite: the
    sharded step's loss and params against both single-device steps."""
    r, ref = spmd["res"]["train_step"], spmd["ref"]
    jl, jparams = ref["jax_train"]
    pl, pparams, _ = ref["port_train"]
    assert abs(r["loss"] - jl) < LOSS_BAND
    assert abs(r["loss"] - pl) < LOSS_BAND
    assert _max_gap(r["params"], jparams) < PARAM_BAND
    assert _max_gap(r["params"], [p.numpy() for p in pparams]) < PARAM_BAND


def test_each_rank_stores_exactly_its_shard(spmd):
    """Params and momentum come back on the placements ``param_specs``
    gives, and every rank's local shards are the slices of the
    single-process step's result that those placements name."""
    _, pparams, pvel = spmd["ref"]["port_train"]
    coords = [(r // MESH_SHAPE[1], r % MESH_SHAPE[1]) for r in range(WORLD)]
    sharded = 0
    for rank, loc in enumerate(spmd["local"]):
        assert loc["placements"] == loc["want"]
        assert loc["v_placements"] == loc["want"]
        for got, whole, pl in zip(loc["params"] + loc["v"],
                                  pparams + pvel,
                                  loc["want"] * 2):
            want = whole
            for axis, (kind, dim) in enumerate(pl):
                if kind == "S":
                    want = want.chunk(MESH_SHAPE[axis],
                                      dim=dim)[coords[rank][axis]]
                    sharded += 1
            assert got.shape == want.shape
            assert float((got - want).abs().max()) < PARAM_BAND
    assert sharded > 0


def test_moe_groups_and_aux_are_global(spmd):
    """(b) and (c): the sharded granite run routes on the global token
    count and takes the aux loss from global means; the planted per-rank
    forms land outside the bands."""
    r, ref = spmd["res"]["train_step"], spmd["ref"]
    assert abs(r["aux"] - ref["jax_aux"]) < AUX_BAND
    assert abs(r["fault_c_aux"] - ref["jax_aux"]) > AUX_BAND
    assert abs(r["fault_b_loss"] - ref["jax_train"][0]) > LOSS_BAND


def test_activation_sharding_preserves_values(spmd):
    """Reduced gemma3-4b (4 heads) under ``activation_sharding``: the
    constrained forward equals the unconstrained one and the single-device
    forwards of both packages; so does reduced granite's."""
    r, ref = spmd["res"]["gemma"], spmd["ref"]
    c = r["constrained"].numpy()
    assert float(np.abs(c - r["free"].numpy()).max()) < LOSS_BAND
    assert float(np.abs(c - ref["jax_gemma"]).max()) < LOSS_BAND
    assert float(np.abs(c - ref["port_gemma"].numpy()).max()) < LOSS_BAND
    # the MoE layer's constrain_first calls change no value either
    assert r["moe_gap"] < LOSS_BAND and r["moe_aux_gap"] < AUX_BAND


def test_constrain_placements(spmd):
    r = spmd["res"]["constrain"]
    assert r["outside"] == "(Replicate(), Replicate())"
    assert r["bh"] == "(Shard(dim=0), Shard(dim=2))"
    assert r["values_kept"]
    # "m" on a dim of 4 takes the model axis before "h" could
    assert r["undivided"] == "(Shard(dim=0), Shard(dim=1))"
    # 5 experts do not divide the model axis of 2: the ff dim shards
    assert r["first_fallback"] == "(Shard(dim=0), Shard(dim=3))"
    assert r["plain_is_noop"]


@pytest.mark.parametrize("form", ["fused", "weighted", "granite_fused"])
def test_engine_mesh_run_matches_per_step_runs(spmd, form):
    """``TrainEngine(mesh=...)`` through ``SpmdBackend`` on the example's
    plan and phase: params stay DTensors, the fused forms run B2 once per
    leaf per step (its plain form on the CPU) and no B1, and every form
    matches the non-mesh per-step runs of the port and the reference.
    The small group's 9 rows do not divide the 4 data ranks: granite's
    MoE dispatch must still see exactly the group's rows."""
    r = spmd["res"]["engine"][form]
    ref = spmd["ref"]["engine"][form]
    assert r["dtensor"] and len(r["losses"]) == ENGINE_STEPS
    assert r["launches"] == 0 and r["b1_plain"] == 0
    assert r["b2_plain"] == (0 if form == "weighted"
                             else ENGINE_STEPS * r["leaves"])
    for losses, params in (ref["port"], ref["ref"]):
        assert max(abs(a - b) for a, b in zip(r["losses"], losses)) \
            <= ENGINE_BAND["loss"]
        assert _max_gap(r["params"], params) <= ENGINE_BAND["params"]
    if form != "weighted":
        assert r["losses"][-1] < r["losses"][0]


def test_engine_mesh_padded_group_fault_lands_outside(spmd):
    """Planted fault (b) in the fused step: granite's small group padded
    to the data ranks with weight-0 rows changes the MoE dispatch, and
    the run leaves the band around the non-mesh run."""
    r = spmd["res"]["engine"]["granite_padded"]
    losses, params = spmd["ref"]["engine"]["granite_fused"]["port"]
    assert max(abs(a - b) for a, b in zip(r["losses"], losses)) \
        > ENGINE_BAND["loss"] \
        or _max_gap(r["params"], params) > ENGINE_BAND["params"]


def test_mesh_checkpoint_holds_the_full_tree(spmd):
    """Rank 0 writes the mesh run's full tree: the same keys, shapes,
    dtypes and bytes as a non-mesh save of the same values."""
    work = spmd["work"]
    with np.load(os.path.join(work, "ckpt_mesh", "ckpt_00000001.npz")) as a, \
            np.load(os.path.join(work, "ckpt_plain",
                                 "ckpt_00000001.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
        shapes = {k: a[k].shape for k in a.files}
    embed = spmd["inputs"]["phi3_params"]["embed"]
    assert shapes["params/embed"] == tuple(embed.shape)


def test_leafwise_dbl_merge_bit_equal_to_flat(spmd):
    """Any DTensor tree, sharded or replicated, takes one B2 run per leaf
    on its shard, in place, bit-equal to the flat form on the whole
    tree; the flat form refuses a DTensor tree."""
    r = spmd["res"]["leafwise"]
    assert r["gap"] == 0.0
    assert r["runs"] == r["leaves"] and r["in_place"]
    assert r["replicated_runs"] == r["leaves"] and r["replicated_dtensor"]
    assert "pass leafwise=True" in r["flat_refusal"]


def test_engine_refuses_momentum_and_bf16_with_a_mesh(spmd):
    r = spmd["res"]["refusals"]
    assert r["momentum"] == ("server_momentum requires the fused scan path "
                             "(scan_loop enabled, fused_merge on, no mesh)")
    assert r["bf16"] == ("precision='bf16' requires the fused scan path "
                         "(scan_loop enabled, fused_merge on, no mesh)")


def test_mesh_builders(spmd):
    """``make_host_mesh``: the model axis the first of 4, 2, 1 dividing
    the world (8 -> (2, 4)); ``make_production_mesh`` names the world it
    needs."""
    r = spmd["res"]["meshes"]
    assert r["host"] == {"data": 2, "model": 4}
    assert r["data_axes"] == ("data",)
    assert "needs a world of 256 ranks" in r["production_False"]
    assert "needs a world of 512 ranks" in r["production_True"]


def test_spmd_module_stays_inside_its_time(spmd):
    """The ranks' cases and the references together, well inside the
    spawn's timeout."""
    print("rank 0 seconds per case:", spmd["res"]["seconds"],
          "module:", spmd["seconds"], "references:", spmd["ref_seconds"])
    assert spmd["seconds"] < SPAWN_TIMEOUT_S
    assert sum(spmd["res"]["seconds"].values()) < SPAWN_TIMEOUT_S


# ------------------------------------- leafwise dbl_merge in one process
def test_leafwise_dbl_merge_plain_tensors_bit_equal_and_padded():
    """On plain tensors the leafwise form is one B2 run per leaf, in
    place, bit-equal to the flat form; a leaf whose size is no multiple
    of the lane width goes through the padded store layout."""
    from repro_torch.kernels import dbl_merge as K
    from repro_torch.kernels.ops import dbl_merge
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 5, generator=gen),
            "b": [torch.randn(256, generator=gen),
                  torch.randn(2, 128, generator=gen)]}
    gl = tree_map(lambda p: torch.randn(p.shape, generator=gen), tree)
    gs = tree_map(lambda p: torch.randn(p.shape, generator=gen), tree)
    flat = dbl_merge(tree_map(torch.clone, tree), gl, gs, factor=0.7,
                     lr=0.01)
    mine = tree_map(torch.clone, tree)
    K.reset_counts()
    out = dbl_merge(mine, gl, gs, factor=0.7, lr=0.01, leafwise=True)
    assert K.plain_count("dbl_merge_flat2d") == 3 and K.launch_count() == 0
    for a, b, c in zip(tree_leaves(out), tree_leaves(flat),
                       tree_leaves(mine)):
        assert a is c and torch.equal(a, b)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
