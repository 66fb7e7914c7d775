"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's: the same tree written by either package gives the same file,
byte for byte; each package restores the other's; a shape mismatch and a
missing leaf are refused; and both port backends resume from a phase
boundary bit for bit.

``np.savez`` stamps each zip entry with the time of writing (to 2 s), so
the byte comparisons pin the clock while both files are written."""
import collections
import hashlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.core.flat import FlatParams as JFlatParams
from repro.core.flat import flat_spec as jflat_spec
from repro.optim import adamw as jadamw
from repro_torch import models
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    restore_latest, save_checkpoint)
from repro_torch.cluster import BSP, PsSimBackend, SpmdBackend
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import LinearTimeModel, solve_plan
from repro_torch.core.flat import FlatParams, flat_spec
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.engine import TrainEngine, single_phase
from repro_torch.engine.phases import Phase
from repro_torch.optim import adamw, make_optimizer, sgd_momentum

torch.set_num_threads(1)

Pt = collections.namedtuple("Pt", ["x", "y"])


def _numpy_tree(seed=0):
    """A tree of every leaf kind a checkpoint holds, as numpy arrays (bf16
    as ``ml_dtypes``' type, which JAX hands numpy)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": n(13, 7),
            "blocks": [n(130), {"scale": np.float32(1.5),
                                "bias": n(5, 3, 2).astype(jnp.bfloat16)}],
            "head": n(64, 64)}


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _port_tree(t):
    return params_from_numpy(t, "cpu")


def _both(kind):
    """(JAX tree, port tree) of the same values for one case."""
    base = _numpy_tree()
    if kind == "tree":
        return _jax_tree(base), _port_tree(base)
    if kind in ("flat_f32", "flat_bf16"):
        jt, tt = _jax_tree(base), _port_tree(base)
        if kind == "flat_f32":
            return ({"params": JFlatParams.from_tree(jt)},
                    {"params": FlatParams.from_tree(tt)})
        return ({"params": JFlatParams.from_tree(
            jt, spec=jflat_spec(jt, jnp.bfloat16))},
            {"params": FlatParams.from_tree(
                tt, spec=flat_spec(tt, torch.bfloat16))})
    if kind == "namedtuple":
        a = np.arange(4, dtype=np.float32)
        b = np.ones((2, 3), np.float32)
        return ({"state": Pt(jnp.asarray(a), jnp.asarray(b)), "none": None},
                {"state": Pt(torch.from_numpy(a), torch.from_numpy(b)),
                 "none": None})
    if kind == "ps_meta":
        return ({"params": _jax_tree(base), "clock": np.float64(1 / 3),
                 "epochs": np.int64(7)},
                {"params": _port_tree(base), "clock": np.float64(1 / 3),
                 "epochs": np.int64(7)})
    if kind == "adamw":
        # one step of each package's own AdamW (bit-equal updates): the
        # state's step count is a 0-d int32 in both
        jt, tt = _jax_tree(base), _port_tree(base)
        jo, to = jadamw(), adamw()
        g = {"w": 0.01, "blocks": [0.02, {"scale": -0.01, "bias": 0.03}],
             "head": -0.02}
        jt, js = jo.update(jax.tree_util.tree_map(
            lambda x, v: jnp.full_like(x, v), jt, g), jo.init(jt), jt, 3e-3)
        tt, ts = to.update(tree_map(lambda x, v: torch.full_like(x, v), tt,
                                    g), to.init(tt), tt, 3e-3)
        return ({"params": jt, "opt_state": js},
                {"params": tt, "opt_state": ts})
    raise ValueError(kind)


KINDS = ["tree", "flat_f32", "flat_bf16", "namedtuple", "ps_meta", "adamw"]


def _sha(f):
    return hashlib.sha256(open(f, "rb").read()).hexdigest()


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both packages' zip entries stamped with one time."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)


@pytest.mark.parametrize("kind", KINDS)
def test_file_bytes_identical_to_reference(tmp_path, pinned_clock, kind):
    jt, tt = _both(kind)
    f1 = jsave(str(tmp_path / "ref"), 3, jt)
    f2 = save_checkpoint(str(tmp_path / "port"), 3, tt)
    assert _sha(f1) == _sha(f2)


def test_file_bytes_identical_flat_vs_tree(tmp_path, pinned_clock):
    """The reference's property on the port: a tree, its f32 flat store
    and its bf16 flat store (whose f32 master is the value of record)
    write the same file."""
    tree = _port_tree(_numpy_tree())
    files = [save_checkpoint(str(tmp_path / k), 1, {"params": p})
             for k, p in (("tree", tree), ("f32", FlatParams.from_tree(tree)),
                          ("bf16", FlatParams.from_tree(
                              tree, spec=flat_spec(tree, torch.bfloat16))))]
    assert len({_sha(f) for f in files}) == 1


def _port_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x.dtype == y.dtype and torch.equal(x, y))
        if isinstance(x, torch.Tensor)
        else (np.asarray(x).dtype == np.asarray(y).dtype
              and np.array_equal(x, y)) for x, y in zip(la, lb))


def _expand(t):
    if isinstance(t, FlatParams):
        return t.to_tree()
    if isinstance(t, dict):
        return {k: _expand(v) for k, v in t.items()}
    return t


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_loads_the_others_file(tmp_path, kind):
    jt, tt = _both(kind)
    fj = str(tmp_path / "ref")
    fp = str(tmp_path / "port")
    jsave(fj, 2, jt)
    save_checkpoint(fp, 2, tt)
    # the port restores the reference's file into its own structure
    got = load_checkpoint(fj, 2, tt)
    assert _port_equal(_expand(got), _expand(tt))
    if kind == "namedtuple":
        assert isinstance(got["state"], Pt) and got["none"] is None
    if kind == "flat_bf16":
        fpar = got["params"]
        assert fpar.buf.dtype == torch.bfloat16 and \
            fpar.master.dtype == torch.float32
        assert torch.equal(fpar.buf, fpar.master.to(torch.bfloat16))
    # the reference restores the port's file into its own
    back = jload(fp, 2, jt)
    unwrap = lambda t: jax.tree_util.tree_map(
        lambda l: l.to_tree() if isinstance(l, JFlatParams) else l, t,
        is_leaf=lambda l: isinstance(l, JFlatParams))
    for a, b in zip(jax.tree_util.tree_leaves(unwrap(back)),
                    jax.tree_util.tree_leaves(unwrap(jt))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a, np.float32) if a.dtype ==
                              jnp.bfloat16 else np.asarray(a),
                              np.asarray(b, np.float32) if b.dtype ==
                              jnp.bfloat16 else np.asarray(b))


def test_roundtrip_keeps_dtypes_devices_and_numpy_scalars(tmp_path):
    """The reference's roundtrip test on the port: tensors come back at
    their dtypes (bf16 through the file's f32), numpy scalars as numpy at
    their exact dtype; ``latest_step`` finds the newest file."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16)},
            "lst": [torch.zeros(2), torch.tensor(3.0)],
            "clock": np.float64(0.1), "n": np.int64(5)}
    path = str(tmp_path / "ck")
    assert latest_step(path) is None
    assert restore_latest(path, tree) == (None, None)
    save_checkpoint(path, 7, tree)
    save_checkpoint(path, 12, tree)
    assert latest_step(path) == 12
    step, back = restore_latest(path, tree)
    assert step == 12 and _port_equal(back, tree)
    assert isinstance(back["clock"], np.ndarray) and \
        back["clock"].dtype == np.float64


def test_refusals(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, 1, {"a": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, 1, {"a": torch.ones(3, 3)})
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        load_checkpoint(path, 1, {"a": torch.ones(2, 2),
                                  "b": torch.ones(1)})


# ---------------------------------------------------------------- resume
TM = LinearTimeModel(a=0.01, b=0.1)


def _quad_backend(**kw):
    """A strongly convex quadratic on the PS simulator (the reference's
    ``quad_problem``): exact gradients, index batches."""
    rng = np.random.RandomState(0)
    A = torch.from_numpy((rng.randn(32, 8) / np.sqrt(8)).astype(np.float32))
    target = torch.from_numpy(rng.randn(32).astype(np.float32))

    def grad_fn(params, idx):
        Ai, bi = A[idx], target[idx]
        return {"x": 2 * Ai.T @ (Ai @ params["x"] - bi) / len(idx)}

    def loss(params):
        r = A @ params["x"] - target
        return float(torch.mean(r * r))

    def data_fn(rng, wid, bsz):
        return torch.from_numpy(rng.integers(0, 32, size=bsz))

    def factory(input_size):
        return grad_fn, data_fn, (lambda p: {"loss": loss(p)})
    return {"x": torch.zeros(8)}, PsSimBackend(factory, tm=TM, device="cpu",
                                               **kw)


def _quad_phases(lrs):
    plan = solve_plan(TM, B_L=8, d=16, n_workers=2, n_small=1, k=1.05)
    return tuple(Phase(input_size=32, n_steps=0, lr=lr, batch_size=8,
                       epochs=2, plan=plan) for lr in lrs)


def test_ps_backend_resume_bit_for_bit(tmp_path):
    """Save mid-schedule, reload, and the resumed run's final params and
    clock match an uninterrupted run's exactly."""
    phases = _quad_phases((0.05, 0.02, 0.01))
    init, b_full = _quad_backend()
    full = b_full.run(phases, init, seed=0)
    ckpt = str(tmp_path / "ps")
    _, b_head = _quad_backend()
    b_head.run(phases[:2], init, seed=0, ckpt_dir=ckpt)
    assert latest_step(ckpt) == 2
    _, b_tail = _quad_backend()
    res = b_tail.run(phases, init, seed=0, ckpt_dir=ckpt, resume=True)
    assert res.resumed_from == 2
    assert [r["phase"] for r in res.phases] == [2]
    assert torch.equal(full.params["x"], res.params["x"])
    assert res.phases[0]["t0"] == full.phases[2]["t0"]
    assert res.time == full.time
    assert [(h["epoch"], h["sim_time"]) for h in res.history] == \
        [(h["epoch"], h["sim_time"]) for h in full.history[-2:]]


def _lm_cfg():
    return reduced(get_config("phi3-mini-3.8b"), layers=1, d_model=32,
                   n_heads=2, vocab=64)


def _batch_fn(cfg):
    def batch_fn(phase, gstep):     # stateless in gstep -> replayable
        g = torch.Generator().manual_seed(gstep)
        tok = torch.randint(0, cfg.vocab_size,
                            (phase.batch_size, phase.input_size),
                            generator=g)
        return {"tokens": tok, "labels": tok}
    return batch_fn


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_spmd_backend_resume_bit_for_bit(tmp_path, optimizer):
    """The reference's resume test on the port: AdamW on the weighted step
    (its int32 step count resumes too), and plain SGD on the fused
    dual-batch path (one ``dbl_apply_flat2d`` a step on the flat store)."""
    cfg = _lm_cfg()
    plan = solve_plan(LinearTimeModel(a=1.0, b=24.6), B_L=4, d=256,
                      n_workers=4, n_small=2, k=1.05)
    phases = single_phase(input_size=16, n_steps=2, lr=0.01, batch_size=4,
                          plan=plan) \
        + single_phase(input_size=16, n_steps=2, lr=0.002, batch_size=4,
                       plan=plan)

    def fresh():
        params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        if optimizer == "adamw":
            return params, TrainEngine(cfg, make_optimizer("adamw"),
                                       device="cpu")
        return params, TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True,
                                   device="cpu")

    params, engine = fresh()
    full = SpmdBackend(engine, _batch_fn(cfg)).run(phases, params, seed=0)
    ckpt = str(tmp_path / "spmd")
    p2, e2 = fresh()
    SpmdBackend(e2, _batch_fn(cfg)).run(phases[:1], p2, seed=0,
                                        ckpt_dir=ckpt)
    p3, e3 = fresh()
    res = SpmdBackend(e3, _batch_fn(cfg)).run(phases, p3, seed=0,
                                              ckpt_dir=ckpt, resume=True,
                                              log_every=1)
    assert res.resumed_from == 1
    assert [h["step"] for h in res.history] == [3, 4]
    assert _port_equal(full.params, res.params)
    assert _port_equal(full.opt_state, res.opt_state)
    if optimizer == "adamw":
        assert int(full.opt_state["t"]) == int(res.opt_state["t"]) == 4
    assert [r["steps"] for r in full.phases] == [2, 2]
    assert latest_step(ckpt) == 2


def test_flat_restore_resumes_both_backends(tmp_path):
    """A phase-boundary file restores into a flat store as into a tree;
    either resumes the engine backend identically, and the simulator
    accepts the flat store as initial params."""
    cfg = _lm_cfg()
    tm = LinearTimeModel(a=1.0, b=24.6)
    plan = solve_plan(tm, B_L=8, d=512, n_workers=4, n_small=2, k=1.05)
    phases = single_phase(input_size=16, n_steps=2, lr=0.01, batch_size=8,
                          plan=plan, epochs=1)
    opt = sgd_momentum(0.0)
    engine = TrainEngine(cfg, opt, sgd_server=True, device="cpu")
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    ckpt = str(tmp_path / "ck")
    res = SpmdBackend(engine, _batch_fn(cfg)).run(phases, params, seed=0,
                                                  ckpt_dir=ckpt)
    zeros = tree_map(torch.zeros_like, res.params)
    step_t, tree_t = restore_latest(ckpt, {"params": zeros,
                                           "opt_state": opt.init(params)})
    step_f, tree_f = restore_latest(ckpt, {"params": FlatParams.from_tree(
        zeros), "opt_state": opt.init(params)})
    assert step_t == step_f == 1 and isinstance(tree_f["params"], FlatParams)
    assert _port_equal(tree_t["params"], tree_f["params"].to_tree())
    assert _port_equal(tree_t["params"], res.params)
    extra = single_phase(input_size=16, n_steps=2, lr=0.001, batch_size=8,
                         plan=plan, epochs=1)
    r1 = SpmdBackend(engine, _batch_fn(cfg)).run(extra, tree_f["params"],
                                                 seed=1)
    r2 = SpmdBackend(engine, _batch_fn(cfg)).run(extra, tree_t["params"],
                                                 seed=1)
    assert _port_equal(r1.params, r2.params)

    def factory(input_size):
        def grad_fn(p, b):
            leaves = tree_leaves(p)
            xs = [l.detach().requires_grad_() for l in leaves]
            from repro_torch.core.tree import tree_flatten, tree_unflatten
            _, td = tree_flatten(p)
            loss, _ = models.loss_fn(tree_unflatten(td, xs), cfg, b)
            return tree_unflatten(td, list(torch.autograd.grad(loss, xs)))
        bf = _batch_fn(cfg)

        def data_fn(rng, wid, bsz):
            return bf(phases[0], int(rng.integers(0, 4)))
        return grad_fn, data_fn, None
    sim = PsSimBackend(factory, tm=tm, sync=BSP(), momentum=0.0,
                       device="cpu")
    r_flat = sim.run(phases, tree_f["params"], seed=0)
    r_tree = sim.run(phases, tree_t["params"], seed=0)
    assert _port_equal(r_flat.params, r_tree.params)
