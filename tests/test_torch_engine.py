"""The port's slice as a whole against the JAX reference: the hybrid
dual-batch x CPL schedule (width-8 ResNet-18, 10 classes, 24 px x 3 steps
at global batch 28, then 32 px x 3 at 16), on parameters converted from
the same JAX init and on the same DataPlane streams, in the f32, server
momentum, per-step (``scan_loop=False``, B2) and bf16-master forms.

Two levels of agreement are held:

* teacher-forced, at the spec's lr 0.05: at every step the port's step
  function is handed the reference's state (params, velocity, master) and
  batch; its loss must match the reference step's, and its updated state
  the reference's and the same step evaluated in float64.  This is where
  the kernels, the flat codec, the merged-loss backward and the data are
  held tightly, and planted faults are shown to break the limits.
* free-running, through ``repro.api.run`` and ``repro_torch.api.run``:
  the two runs train on their own for the whole schedule.  ResNet-18
  training amplifies float-level differences (the instance norm divides
  by sqrt(var + 1e-5) of near-constant channels): the reference itself,
  started from params perturbed by 2e-7 relative noise (~2 ulp), ends
  1.6e-2 (relative loss) / 4.2e-2 (params) away from its unperturbed run
  at lr 0.05, and 2.9e-4 / 8.1e-4 at lr 0.005.  So the free-running check
  runs at lr 0.005 and its bands are a few times that sensitivity.
"""
import dataclasses
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
from repro.configs import get_config as jget_config
from repro.core.flat import flat_spec as jflat_spec
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticImages as JSyntheticImages
from repro.engine.engine import TrainEngine as JTrainEngine
from repro.engine.steps import make_fused_dbl_step as jmake_fused_dbl_step
from repro.engine.steps import make_fused_phase_scan as jmake_fused_phase_scan
from repro.optim import sgd_momentum as jsgd_momentum
from repro_torch.api import RunConfig, ScheduleSpec, run
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy, \
    tensor_to_numpy
from repro_torch.core.flat import flat_spec
from repro_torch.core.spmd_dual_batch import SpmdDualBatch
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.data import SyntheticImages
from repro_torch.engine import TrainEngine
from repro_torch.engine.steps import make_fused_dbl_step, make_fused_phase_scan
from repro_torch.kernels import dbl_merge as K
from repro_torch.models import resnet
from repro_torch.optim import sgd_momentum

torch.set_num_threads(1)

SPEC = dict(scheme="hybrid", input_size=32, axis="resolution", batch_size=16,
            dataset_size=256, n_workers=4, n_small=3, k=1.05, n_steps=6,
            sub_sizes=(24, 32), sub_dropouts=(0.0, 0.0), stage_epochs=(2,),
            stage_lrs=(0.05,), tm_a=1.0, tm_b=24.6, seed=0)

VARIANTS = {
    "f32": {},
    "momentum": {"server_momentum": 0.9},
    "per_step": {"scan_loop": False},
    "bf16": {"precision": "bf16"},
}


def _cfgs():
    jcfg = replace(jget_config("cifar-resnet18"), d_model=8, vocab_size=10)
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    return jcfg, cfg


def _sources():
    kw = dict(n_train=256, n_test=32, num_classes=10, seed=0)
    return JSyntheticImages(**kw), SyntheticImages(**kw)


@functools.lru_cache(maxsize=1)
def _init():
    jcfg, _ = _cfgs()
    init = jax.jit(lambda k: jmodels.init_params(jcfg, k))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def _np(x):
    return np.array(x, dtype=np.float32)


# ------------------------------ teacher-forced ------------------------------
# At every step the port's step function is handed the reference's state
# and batch.  Its merged loss is held against the reference's, and its
# updated state against the reference's and against the same step
# evaluated in float64 (the port's model in double, on the reference's
# state; ``_f64_step``).  The f64 step separates the two sides' f32
# rounding.  Measured (max abs; L2 of the gap relative to the update),
# port vs reference / reference vs f64 / port vs f64:
#   most steps, every variant: <= 1.3e-7 / 1.3e-7 / 1.1e-7 (velocity
#     2.4e-6 / 2.4e-6 / 1.8e-6); L2 <= 7.4e-6 / 7.3e-6 / 6.9e-6
#   per_step step 5:   3.34e-4 / 3.34e-4 / 6.3e-8;  L2 4.9e-3 / 4.9e-3 / 5.4e-6
#   f32 step 3:        1.22e-5 / 1.22e-5 / 1.1e-7;  L2 7.4e-4 / 7.4e-4 / 6.9e-6
#   momentum step 5:   5.36e-5 / 5.36e-5 / 7.6e-8 (velocity 1.07e-3 /
#                      1.07e-3 / 7.7e-7)
#   bf16 steps 4 / 6:  7.6e-6 / 5.3e-5 off the reference, which is that far
#                      off the f64 step; the port is 7.6e-8 / 6.2e-8 off it
#   bf16 step 1:       1.3e-7 / 3.5e-5 / 3.5e-5 (a stage-0 3x3 conv's
#                      gradient): both f32 evaluations round alike there
# So every outlier of the port against the reference is the jitted
# reference's own distance from the f64 step.  The limits hold the port,
# on every step, no further from the f64 step than the reference is, and
# no further from the reference than the reference is from the f64 step,
# each plus about ten f32 roundings.
# Planted faults in the port (``FAULTS``, f32 and per_step) break them on
# every step (``test_teacher_forced_limits_reject_planted_faults``):
#   factor f set to 1:    loss 5.3e-6..3.1e-3 rel, params vs f64 L2 2.6e-2..3.6e-2
#   small group dropped:  loss 1.6e-4..9.1e-2 rel, params vs f64 L2 0.76..1.06
#   lr off by 1 %:        loss unchanged,          params vs f64 L2 1.0e-2
TF_LOSS_REL = 1e-5            # merged loss vs the reference (<= 3.3e-7)
TF64_ATOL = {"p": 1e-6, "m": 1e-6, "v": 2e-5}   # every element
TF64_REL_L2 = 2e-5            # L2, relative to the update


def _f64_step(cfg, layout, lr, mom, tspec, x, base, v, batch):
    """The step in float64: the merged gradient of ``(L_L + f·L_S)/(1+f)``
    at the flat params ``x``, then ``v' = mom·v + g`` and
    ``base' = base − lr·v'`` (``base`` is ``x`` itself, or the f32 master
    of a bf16 store).  The groups are cut from the layout here, not by the
    port's step code.  Returns the flat f64 results by name."""
    pw = layout.global_batch // layout.n_workers
    nl = (layout.n_workers - layout.n_small) * pw
    small = [nl + w * pw + j for w in range(layout.n_small)
             for j in range(layout.small_valid)]
    f = float(layout.factor_small)
    xt = torch.from_numpy(np.asarray(x, np.float64).reshape(-1)) \
        .requires_grad_()
    leaves = [xt[o:o + sz].view(shape) for o, sz, shape in
              zip(tspec.offsets, tspec.sizes, tspec.shapes)]
    tree = tree_unflatten(tspec.treedef, leaves)
    images = torch.from_numpy(batch["images"]).double()
    labels = torch.from_numpy(batch["labels"]).long()

    def ce(rows):
        logits = resnet.forward(tree, cfg, images[rows])
        lab = labels[rows]
        return (torch.logsumexp(logits, -1)
                - logits.gather(-1, lab[:, None])[:, 0]).mean()
    loss = (ce(slice(0, nl)) + f * ce(small)) / (1.0 + f)
    (g,) = torch.autograd.grad(loss, xt)
    g = g.numpy()
    out = {}
    if v is not None:
        g = out["v"] = mom * np.asarray(v, np.float64).reshape(-1) + g
    out["base"] = np.asarray(base, np.float64).reshape(-1) - lr * g
    return out


def _ref_step(variant, jcfg, layout, lr, jspec):
    if variant == "per_step":
        return jax.jit(jmake_fused_dbl_step(jcfg, layout), static_argnums=(3,))
    mom = 0.9 if variant == "momentum" else 0.0
    return jax.jit(jmake_fused_phase_scan(jcfg, layout, jspec, lr=lr,
                                          momentum=mom))


# planted faults in the port's step, each of which the limits must reject
FAULTS = {
    "factor_one": lambda layout, lr: (replace(layout, factor_small=1.0), lr),
    "small_dropped": lambda layout, lr: (replace(layout, factor_small=0.0),
                                         lr),
    "lr_off_1pct": lambda layout, lr: (layout, lr * 1.01),
}


def _port_step(variant, cfg, layout, lr, tspec, fault=None):
    layout = SpmdDualBatch(**dataclasses.asdict(layout))
    if fault is not None:
        layout, lr = FAULTS[fault](layout, lr)
    if variant == "per_step":
        step = make_fused_dbl_step(cfg, layout)
        return lambda p, s, b, _lr: step(p, s, b, lr)
    mom = 0.9 if variant == "momentum" else 0.0
    return make_fused_phase_scan(cfg, layout, tspec, lr=lr, momentum=mom)


def _teacher_forced(variant, fault=None):
    """Each of the schedule's 6 steps, by the reference and by the port on
    the reference's state.  Returns one reading per step: the merged
    loss's relative gap, and per updated buffer (max abs gap, gap in L2
    relative to the reference's update)."""
    jcfg, cfg = _cfgs()
    jsrc, _ = _sources()
    np0 = _init()
    phases = JScheduleSpec(**SPEC).to_phases()
    plane = JDataPlane(jsrc, seed=SPEC["seed"])
    plane.bind(phases)
    bf16 = variant == "bf16"
    jp = jax.tree_util.tree_map(jnp.asarray, np0)
    jspec = jflat_spec(jp, jnp.bfloat16 if bf16 else None)
    tspec = flat_spec(params_from_numpy(np0, "cpu"),
                      torch.bfloat16 if bf16 else None)
    if variant == "per_step":
        state = {"p": jp}
    else:
        state = {"p": jspec.ravel(jp)}
        if bf16:
            state["m"] = jspec.ravel_master(jp)
        if variant == "momentum":
            state["v"] = jnp.zeros(jspec.shape, jnp.float32)
    K.reset_counts()
    g, readings = 0, []
    for ph in phases:
        ref = _ref_step(variant, jcfg, ph.layout, ph.lr, jspec)
        port = _port_step(variant, cfg, ph.layout, ph.lr, tspec, fault)
        lr, mom = float(ph.lr), 0.9 if variant == "momentum" else 0.0
        for _ in range(ph.n_steps):
            b = plane(ph, g)
            g += 1
            if variant == "per_step":
                tp = params_from_numpy(jax.tree_util.tree_map(
                    _np, state["p"]), "cpu")
                new_p, _, jm = ref(state["p"], None,
                                   {k: jnp.asarray(v) for k, v in b.items()},
                                   ph.lr)
                tp, _, tm = port(tp, None,
                                 {k: torch.from_numpy(v) for k, v in
                                  b.items()}, ph.lr)
                jloss, tloss = float(jm["loss"]), float(tm["loss"])
                old = _np(jspec.ravel(state["p"]))
                truth = _f64_step(cfg, ph.layout, lr, 0.0, tspec, old, old,
                                  None, b)
                state = {"p": new_p}
                pairs = {"p": (tspec.ravel(tp), jspec.ravel(new_p), old,
                               truth["base"])}
            else:
                t = {k: tensor_from_numpy(np.asarray(v), "cpu").clone()
                     for k, v in state.items()}
                jb = {k: jnp.asarray(v)[None] for k, v in b.items()}
                tb = {k: torch.from_numpy(v)[None] for k, v in b.items()}
                jp2 = (state["p"], state["m"]) if bf16 else state["p"]
                tp2 = (t["p"], t["m"]) if bf16 else t["p"]
                jn, jv, jl = ref(jp2, state.get("v"), jb, None)
                old = {k: _np(v) for k, v in state.items()}
                truth = _f64_step(cfg, ph.layout, lr, mom, tspec, old["p"],
                                  old["m" if bf16 else "p"], old.get("v"), b)
                truth["m" if bf16 else "p"] = truth.pop("base")
                _, _, tl = port(tp2, t.get("v"), tb, None)
                jloss, tloss = float(jl[0]), float(tl[0])
                new = {"p": jn[0], "m": jn[1]} if bf16 else {"p": jn}
                if jv is not None:
                    new["v"] = jv
                pairs = {k: (t[k], new[k], old[k], truth[k]) for k in truth}
                if bf16:
                    # the shadow is exactly the rounded master, and within
                    # one bf16 ulp of the reference's shadow beyond the
                    # two masters' own gap
                    assert torch.equal(t["p"], t["m"].to(torch.bfloat16))
                    m, jm = t["m"].numpy(), np.asarray(new["m"])
                    sh = t["p"].float().numpy()
                    jsh = np.asarray(new["p"]).astype(np.float32)
                    ulp = _bf16_ulp(np.maximum(np.abs(m), np.abs(jm)))
                    assert np.all(np.abs(sh - jsh) <= ulp + np.abs(m - jm))
                state = new
            reading = {"loss_rel": abs(tloss - jloss) / abs(jloss)}
            for name, (got, want, old, exact) in pairs.items():
                got = got.numpy().reshape(-1).astype(np.float64)
                want = np.asarray(want, np.float64).reshape(-1)
                upd = max(np.linalg.norm(exact - old.reshape(-1)), 1e-30)
                reading[name] = {
                    pair: (float(np.max(np.abs(a - b))),
                           float(np.linalg.norm(a - b) / upd))
                    for pair, (a, b) in (("port_ref", (got, want)),
                                         ("ref_f64", (want, exact)),
                                         ("port_f64", (got, exact)))}
            readings.append(reading)
    # every update went through the plain version, once per step
    kernel = "dbl_merge_flat2d" if variant == "per_step" \
        else "dbl_apply_flat2d"
    assert K.plain_count(kernel) == 6 == K.plain_count()
    assert K.launch_count() == 0
    return readings


def _limits_broken(readings):
    """The teacher-forced limits that ``readings`` break (empty: none)."""
    broken = set()
    for r in readings:
        if r["loss_rel"] > TF_LOSS_REL:
            broken.add("loss_rel")
        for name in [k for k in r if k != "loss_rel"]:
            atol, rel = TF64_ATOL[name], TF64_REL_L2
            (pf, pf_l2), (rf, rf_l2), (pr, pr_l2) = (
                r[name][k] for k in ("port_f64", "ref_f64", "port_ref"))
            if pf > rf + atol or pf_l2 > rf_l2 + rel:
                broken.add(f"{name} vs f64")
            if pr > rf + atol or pr_l2 > rf_l2 + rel:
                broken.add(f"{name} vs reference")
    return sorted(broken)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_steps_teacher_forced_match_reference(variant):
    readings = _teacher_forced(variant)
    assert not _limits_broken(readings), readings


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("variant", ["f32", "per_step"])
def test_teacher_forced_limits_reject_planted_faults(variant, fault):
    readings = _teacher_forced(variant, fault)
    # every step breaks at least one limit
    assert all(_limits_broken([r]) for r in readings), readings


# ------------------------------- free-running -------------------------------
# measured gaps at lr 0.005 (port vs reference), loss rel / params abs:
#   f32 3.7e-5 / 1.4e-4, momentum 0 / 4.0e-5, per_step 0 / 1.6e-4,
#   bf16 3.7e-4 / 7.8e-4 (losses are compared as the history records
#   them, rounded to 4 decimals).  Over the run the params move by up to
#   1.2e-2 (3.3e-2 with momentum), so the params band is a sixth of that.
#   These bands cannot see a fault as small as an lr 1 % off (it would
#   move the end params by about 1e-2 of their movement, below the
#   reference's own 2-ulp sensitivity); the teacher-forced limits do.
FREE_LR = 0.005
FREE_TOL = {"loss_rel": 1e-3, "params": 2e-3}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_free_running_matches_reference(variant):
    ekw = VARIANTS[variant]
    prec = ekw.get("precision", "f32")
    spec = dict(SPEC, stage_lrs=(FREE_LR,))
    jcfg, cfg = _cfgs()
    jsrc, src = _sources()
    np0 = _init()
    jres = jrun(JScheduleSpec(**spec),
                JRunConfig(backend="spmd", log_every=1, precision=prec),
                init_params=jax.tree_util.tree_map(jnp.asarray, np0),
                engine=JTrainEngine(jcfg, jsgd_momentum(0.0), sgd_server=True,
                                    overlap_compile=False, **ekw),
                plane=JDataPlane(jsrc, seed=0))
    K.reset_counts()
    tres = run(ScheduleSpec(**spec),
               RunConfig(backend="spmd", log_every=1, precision=prec),
               init_params=params_from_numpy(np0, "cpu"),
               engine=TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True,
                                  device="cpu", **ekw),
               data=src)
    # same schedule, step for step
    keys = ("step", "phase", "size", "batch", "tokens")
    assert [{k: h[k] for k in keys} for h in tres.history] == \
        [{k: h[k] for k in keys} for h in jres.history]
    assert [(h["size"], h["batch"]) for h in tres.history] == \
        [(24, 28)] * 3 + [(32, 16)] * 3
    # the update went through the plain version once per step (CPU)
    kernel = "dbl_merge_flat2d" if variant == "per_step" \
        else "dbl_apply_flat2d"
    assert K.plain_count(kernel) == 6 and K.launch_count() == 0
    jl = np.array([h["loss"] for h in jres.history])
    tl = np.array([h["loss"] for h in tres.history])
    # step 1 runs on identical params and data: equal up to the 4-decimal
    # rounding of the history record
    assert abs(tl[0] - jl[0]) <= 1e-4
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
    loss_gap = float(np.max(np.abs(tl - jl) / np.abs(jl)))
    pgap = max(float(np.max(np.abs(np.asarray(a, np.float32)
                                   - tensor_to_numpy(b))))
               for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                               tree_leaves(tres.params)))
    # the band is far below how far the params move over the run
    move = max(float(np.max(np.abs(np.asarray(a, np.float32) - b)))
               for a, b in zip(jax.tree_util.tree_leaves(jres.params),
                               jax.tree_util.tree_leaves(np0)))
    assert move >= 5 * FREE_TOL["params"]
    assert loss_gap <= FREE_TOL["loss_rel"]
    assert pgap <= FREE_TOL["params"]
    for leaf in tree_leaves(tres.params):
        assert leaf.dtype == torch.float32 and leaf.device.type == "cpu"
