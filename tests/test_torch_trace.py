"""The port's PS simulator as a whole — the event path, the traced replay
and ``repro_torch.api.run(backend="ps_sim")`` — against itself and against
the JAX package, on a width-8 ResNet-18 (10 classes) at 4 and 8 px.

* Port internal: the traced replay is bit-identical to the event path
  (params, history, ``n_pushes``, ``sim_time``) under BSP, ASP with an
  elastic join + leave, and SSP(1), with jitter 0.2 and two batch sizes,
  through the B3 wrapper (``update="auto"``) and its plain version
  (``"xla"``).  Eager PyTorch runs the same backward and the same float op
  order on both paths, so nothing is left to reassociate.
* Port against the reference: timeline facts exactly (history epochs and
  sim times, ``n_pushes``, ``sim_time``, phase records); params and eval
  losses within bands read off the same run evaluated in float64 (the
  reference is jitted, ROADMAP C2-C4): the port must lie no further from
  the f64 run than the reference does, and no further from the reference
  than the reference lies from the f64 run, each plus ``F32_SLACK``.  A
  planted fault (the small worker's update factor set to 1) breaks them.
* bf16 (the traced replay's bf16 shadow + f32 master): the reference's
  own bands against the f32 event path (``engine/parity.py``: params
  5e-3, eval losses 5e-3 + 1e-2), timeline exact.
* ``repro_torch.engine.parity.check_parity`` runs here, on the CPU.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.api import RunConfig as JRunConfig
from repro.api import ScheduleSpec as JScheduleSpec
from repro.api import run as jrun
from repro.cluster import ClusterEvent as JClusterEvent
from repro.cluster import WorkerSpec as JWorkerSpec
from repro.cluster import simulate as jsimulate
from repro.cluster.trace import simulate_traced as jsimulate_traced
from repro.configs import get_config as jget_config
from repro.data import SyntheticImages as JSyntheticImages
from repro_torch import models
from repro_torch.api import RunConfig, ScheduleSpec, run
from repro_torch.cluster import (BSP, SSP, ASP, ClusterEvent, PsSimBackend,
                                 WorkerSpec, simulate, simulate_traced)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import (tree_flatten, tree_leaves, tree_map,
                                   tree_unflatten)
from repro_torch.data import SyntheticImages
from repro_torch.kernels import dbl_merge as K

torch.set_num_threads(1)

# Measured at lr 0.05 (max abs over the params; eval loss relative):
#   reference event / traced vs f64: 5.0e-9 / 1.05e-7
#   port event / traced vs f64:      1.4e-8 / 0
#   port vs reference:               1.5e-8 / 1.05e-7
#   factor planted at 1:             2.8e-2 / 2.7e-3 (vs f64 and reference)
# and through api.run on SPEC (both port paths): reference vs f64 8.8e-9 /
# 1.03e-7, port vs f64 3.5e-9 / 0, port vs reference 7.5e-9 / 1.03e-7.
F32_SLACK = 5e-8                # about ten f32 roundings of the ~0.1 params
LOSS_REL = 1e-6
BF16_ATOL = 5e-3                # the reference's bf16 bands
BF16_LOSS = BF16_ATOL + 1e-2
N_IMG = 64


def _cfgs():
    return (replace(jget_config("cifar-resnet18"), d_model=8, vocab_size=10),
            replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10))


@functools.lru_cache(maxsize=1)
def _init():
    jcfg, _ = _cfgs()
    init = jax.jit(lambda k: jmodels.init_params(jcfg, k))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=1)
def _bank():
    rs = np.random.RandomState(3)
    return (rs.rand(N_IMG, 8, 8, 3).astype(np.float32),
            rs.randint(0, 10, N_IMG).astype(np.int32))


def _port_fns(cfg, dtype=torch.float32):
    """(grad_fn, data_fn, eval_fn) of the port over the image bank, with
    the images in ``dtype`` (float64 for the f64 evaluation)."""
    imgs, labs = _bank()

    def grad_fn(p, batch):
        leaves, treedef = tree_flatten(p)
        xs = [leaf.detach().requires_grad_() for leaf in leaves]
        batch = dict(batch, images=batch["images"].to(dtype))
        loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, batch)
        return tree_unflatten(treedef, list(torch.autograd.grad(loss, xs)))

    def data_fn(rng, wid, bsz):
        idx = rng.integers(0, N_IMG, size=bsz)
        return {"images": torch.from_numpy(imgs[idx]),
                "labels": torch.from_numpy(labs[idx])}

    def eval_fn(p):
        with torch.no_grad():
            loss, _ = models.loss_fn(p, cfg, {
                "images": torch.from_numpy(imgs[:16]).to(dtype),
                "labels": torch.from_numpy(labs[:16])})
        return {"loss": float(loss)}
    return grad_fn, data_fn, eval_fn


def _ref_fns(jcfg):
    imgs, labs = _bank()

    def grad_fn(p, batch):
        return jax.grad(lambda pp: jmodels.loss_fn(pp, jcfg, batch)[0])(p)

    def data_fn(rng, wid, bsz):
        idx = rng.integers(0, N_IMG, size=bsz)
        return {"images": jnp.asarray(imgs[idx]),
                "labels": jnp.asarray(labs[idx])}

    def eval_fn(p):
        return {"loss": float(jmodels.loss_fn(p, jcfg, {
            "images": jnp.asarray(imgs[:16]),
            "labels": jnp.asarray(labs[:16])})[0])}
    return grad_fn, data_fn, eval_fn


POLICIES = {"bsp": (BSP(), False), "asp_elastic": (ASP(), True),
            "ssp1": (SSP(1), False)}


def _cluster(W, E, elastic, factor=0.8):
    workers = [W(8, 16, 1.0, 0.1, 0.2), W(4, 16, factor, 0.07, 0.2)]
    events = (E(time=0.25, action="join", worker=W(8, 16, 0.5, 0.1, 0.2)),
              E(time=0.8, action="leave", worker_id=1)) if elastic else ()
    return workers, events


def _kw(sync, events):
    return dict(epochs=2, lr_for_epoch=lambda e: 0.05 if e < 1 else 0.01,
                sync=sync, momentum=0.9, seed=7, events=events)


def _port_run(policy, fn=simulate, dtype=torch.float32, factor=0.8, **extra):
    _, cfg = _cfgs()
    sync, elastic = POLICIES[policy]
    workers, events = _cluster(WorkerSpec, ClusterEvent, elastic, factor)
    grad_fn, data_fn, eval_fn = _port_fns(cfg, dtype)
    params = tree_map(lambda t: t.to(dtype), params_from_numpy(_init(),
                                                               "cpu"))
    return fn(params, grad_fn, data_fn, workers, eval_fn=eval_fn,
              **_kw(sync, events), **extra)


@functools.lru_cache(maxsize=None)
def _port_event(policy, dtype=torch.float32, factor=0.8):
    return _port_run(policy, dtype=dtype, factor=factor)


@functools.lru_cache(maxsize=None)
def _ref_run(traced: bool):
    jcfg, _ = _cfgs()
    workers, events = _cluster(JWorkerSpec, JClusterEvent, True)
    grad_fn, data_fn, eval_fn = _ref_fns(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _init())
    if traced:   # short chunks keep the XLA compile of the replay cheap
        return jsimulate_traced(params, grad_fn, data_fn, workers,
                                eval_fn=eval_fn, scan_chunk=2,
                                **_kw("asp", events))
    return jsimulate(params, grad_fn, data_fn, workers, eval_fn=eval_fn,
                     **_kw("asp", events))


def _flat(params) -> np.ndarray:
    """All leaves of a port or reference params tree (same leaf order)."""
    return np.concatenate([
        (leaf.detach().double().numpy() if isinstance(leaf, torch.Tensor)
         else np.asarray(leaf, np.float64)).ravel()
        for leaf in jax.tree_util.tree_leaves(params)])


def _gaps(port, ref, f64):
    """(max abs param gap, largest relative eval-loss gap) per pair."""
    def one(a, b):
        return (float(np.max(np.abs(_flat(a.params) - _flat(b.params)))),
                max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                    for x, y in zip(a.history, b.history)))
    return {"port_f64": one(port, f64), "ref_f64": one(ref, f64),
            "port_ref": one(port, ref)}


def _bands_broken(g):
    (pf, lf), (rf, rlf), (pr, lpr) = (g[k] for k in
                                      ("port_f64", "ref_f64", "port_ref"))
    broken = []
    if pf > rf + F32_SLACK or lf > rlf + LOSS_REL:
        broken.append("port vs f64")
    if pr > rf + F32_SLACK or lpr > rlf + LOSS_REL:
        broken.append("port vs reference")
    return broken


def _timeline(res):
    return (res.n_pushes, res.sim_time,
            [(h["epoch"], h["sim_time"]) for h in res.history])


# --------------------------------------------------------------- internal
@pytest.mark.parametrize("update", ["auto", "xla"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_traced_replay_bit_identical_to_event_path(policy, update):
    ref = _port_event(policy)
    K.reset_counts()
    res = _port_run(policy, fn=simulate_traced, scan_chunk=4, update=update)
    # "auto" goes through the B3 wrapper (its plain version on the CPU),
    # "xla" calls the plain version directly
    assert K.plain_count("dbl_apply_worker_flat2d", "plain") == \
        (res.n_pushes if update == "auto" else 0)
    assert K.launch_count() == 0
    for a, b in zip(tree_leaves(res.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)
    assert res.history == ref.history
    assert (res.n_pushes, res.sim_time) == (ref.n_pushes, ref.sim_time)
    assert res.n_pushes >= 12 and len(res.history) == 2


# ---------------------------------------------------- against the reference
@pytest.mark.parametrize("path", ["event", "traced"])
def test_port_matches_reference_within_f64_bands(path):
    traced = path == "traced"
    port = (_port_run("asp_elastic", fn=simulate_traced, scan_chunk=4)
            if traced else _port_event("asp_elastic"))
    ref = _ref_run(traced)
    assert _timeline(port) == _timeline(ref)
    g = _gaps(port, ref, _port_event("asp_elastic", torch.float64))
    assert not _bands_broken(g), g
    # the bands sit far below how far the params move
    moved = float(np.max(np.abs(_flat(ref.params) - _flat(
        jax.tree_util.tree_map(jnp.asarray, _init())))))
    assert moved > 1e4 * (g["ref_f64"][0] + F32_SLACK)


def test_f64_bands_reject_planted_fault():
    fault = _port_event("asp_elastic", factor=1.0)
    ref = _ref_run(False)
    assert _timeline(fault) == _timeline(ref)   # the timeline cannot see it
    g = _gaps(fault, ref, _port_event("asp_elastic", torch.float64))
    assert _bands_broken(g) == ["port vs f64", "port vs reference"], g


def test_bf16_traced_replay_within_reference_bands():
    K.reset_counts()
    res = _port_run("asp_elastic", fn=simulate_traced, scan_chunk=4,
                    precision="bf16")
    assert K.plain_count("dbl_apply_worker_flat2d", "master") == \
        res.n_pushes == K.plain_count()
    for f32 in (_port_event("asp_elastic"), _ref_run(False)):
        assert _timeline(res) == _timeline(f32)
        assert float(np.max(np.abs(_flat(res.params)
                                   - _flat(f32.params)))) <= BF16_ATOL
        assert all(abs(a["loss"] - b["loss"]) <= BF16_LOSS
                   for a, b in zip(res.history, f32.history))
    assert all(t.dtype == torch.float32 for t in tree_leaves(res.params))


# ------------------------------------------------------ api.run(ps_sim)
# 4 -> 8 px: at 16 px ResNet-18's last stage is 2x2, where the instance
# norm of near-constant channels amplifies float-level differences
# chaotically (f32 vs f64 of the same port run: 0.04 at lr 0.005 and 0.4 at
# lr 0.05 after 16 events, ROADMAP C4); at 4 and 8 px it is 1x1 and the
# f32 runs stay within 4e-9 of the f64 run
SPEC = dict(scheme="hybrid", input_size=8, batch_size=8, dataset_size=64,
            n_workers=4, n_small=3, k=1.05, epochs=2, lr=0.05,
            sub_sizes=(4, 8), sub_dropouts=(0.0, 0.0), stage_epochs=(2,),
            stage_lrs=(0.05,), sync="asp", seed=0)
SRC = dict(n_train=128, n_test=16, num_classes=10, seed=0)


def _port_factory(cfg, data, dtype):
    def fns_factory(res):
        grad_fn, _, _ = _port_fns(cfg, dtype)
        test = data.test_set(res)

        def eval_fn(p):
            with torch.no_grad():
                loss, _ = models.loss_fn(p, cfg, {
                    "images": torch.from_numpy(test["images"]).to(dtype),
                    "labels": torch.from_numpy(test["labels"])})
            return {"loss": float(loss)}
        return grad_fn, None, eval_fn
    return fns_factory


@functools.lru_cache(maxsize=1)
def _ref_api_run():
    jcfg, _ = _cfgs()
    data = JSyntheticImages(**SRC)

    def fns_factory(res):
        grad_fn, _, _ = _ref_fns(jcfg)
        test = {k: jnp.asarray(v) for k, v in data.test_set(res).items()}
        return grad_fn, None, lambda p: {
            "loss": float(jmodels.loss_fn(p, jcfg, test)[0])}
    return jrun(JScheduleSpec(**SPEC), JRunConfig(),
                init_params=jax.tree_util.tree_map(jnp.asarray, _init()),
                fns_factory=fns_factory, data=data)


def _port_api_run(traced, dtype=torch.float32):
    _, cfg = _cfgs()
    data = SyntheticImages(**SRC)
    params = tree_map(lambda t: t.to(dtype), params_from_numpy(_init(),
                                                               "cpu"))
    logs = []
    res = run(ScheduleSpec(**SPEC), RunConfig(traced=traced,
                                              log_fn=logs.append),
              init_params=params, fns_factory=_port_factory(cfg, data, dtype),
              data=data, device="cpu")
    return res, logs


@pytest.mark.parametrize("traced", [False, True], ids=["event", "traced"])
def test_api_run_ps_sim_matches_reference(traced):
    K.reset_counts()
    res, logs = _port_api_run(traced)
    ref = _ref_api_run()
    n = sum(p["steps"] for p in res.phases)
    assert K.plain_count("dbl_apply_worker_flat2d") == (n if traced else 0)
    keys = ("phase", "backend", "input_size", "batch_size", "lr", "steps",
            "time", "t0")
    assert [{k: p[k] for k in keys} for p in res.phases] == \
        [{k: p[k] for k in keys} for p in ref.phases]
    assert [p["input_size"] for p in res.phases] == [4, 8]
    assert [(h["phase"], h["epoch"], h["sim_time"]) for h in res.history] \
        == [(h["phase"], h["epoch"], h["sim_time"]) for h in ref.history]
    assert res.time == ref.time
    assert [(r["phase"], r["kind"], r["events"]) for r in logs] == \
        [(i, "trace" if traced else "event", p["steps"])
         for i, p in enumerate(res.phases)]
    f64, _ = _port_api_run(False, torch.float64)
    g = _gaps(res, ref, f64)
    assert not _bands_broken(g), g
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in tree_leaves(res.params))


# ------------------------------------------------------------- the fences
def test_ps_sim_backend_fences(tmp_path):
    _, cfg = _cfgs()
    data = SyntheticImages(**SRC)
    kw = dict(tm=ScheduleSpec(**SPEC).time_model())
    factory = _port_factory(cfg, data, torch.float32)
    params = params_from_numpy(_init(), "cpu")
    phases = ScheduleSpec(**SPEC).to_phases()
    with pytest.raises(ValueError, match="requires traced=True"):
        PsSimBackend(factory, precision="bf16", device="cpu", **kw)
    backend = PsSimBackend(factory, device="cpu", **kw)
    # a phase-boundary checkpoint that lacks the params is refused on
    # resume, before any phase runs
    from repro_torch.checkpoint import save_checkpoint
    save_checkpoint(str(tmp_path), 1, {"params": {}, "clock": np.float64(0),
                                       "epochs": np.int64(1)})
    with pytest.raises(KeyError, match="missing leaf"):
        backend.run(phases, params, ckpt_dir=str(tmp_path), resume=True)
    with pytest.raises(ValueError, match="live on meta"):
        backend.run(phases, tree_map(lambda t: t.to("meta"), params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PsSimBackend(factory, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(ScheduleSpec(**SPEC), RunConfig(), init_params=params,
                fns_factory=factory, data=data)
    with pytest.raises(ValueError, match="fns_factory"):
        run(ScheduleSpec(**SPEC), RunConfig(), init_params=params,
            data=data, device="cpu")


def test_parity_module_runs_on_cpu():
    from repro_torch.engine.parity import check_parity
    out = check_parity(device="cpu")
    assert out["trace"]["configs_checked"] == 6
    assert out["trace_bf16"]["configs_checked"] == 6
    assert out["backend"]["max_param_diff"] < 2e-5
