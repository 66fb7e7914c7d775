"""The port's PS-simulator timeline and its B3 kernel's plain version
against the JAX package, on the CPU.

* Timeline, held exactly: sync policies, ``workers_from_plan``,
  ``run_event_loop`` and ``schedule_pass`` (the ``SimTrace`` arrays,
  evals, segments, chunk ranges and worker count) under BSP, ASP and
  SSP(1) with jitter 0.2, heterogeneous time models, two batch sizes, and
  with and without an elastic join + leave; the DataPlane's simulator
  feeds sample for sample.
* B3 (``dbl_apply_worker_flat2d``): the plain version bit for bit against
  the reference's eager ``dbl_apply_worker_xla``, and within 4.8e-7 of the
  Pallas kernel in interpret mode (jitted XLA:CPU reassociates by a few
  ulp, ROADMAP C2), for both variants at a whole-buffer shape (64 rows,
  3 workers) and a gridded one (3072 rows, 4 workers; worker block 512
  rows); every other worker's velocity rows stay bit-unchanged.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ScheduleSpec as JScheduleSpec
from repro.cluster import sync as jsync
from repro.cluster import topology as jtopo
from repro.cluster.simulator import run_event_loop as jrun_event_loop
from repro.cluster.trace import _chunk_ranges as j_chunk_ranges
from repro.cluster.trace import schedule_pass as jschedule_pass
from repro.cluster.trace import trace_signature as jtrace_signature
from repro.core.dual_batch import solve_plan as jsolve_plan
from repro.core.time_model import LinearTimeModel as JLinearTimeModel
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticImages as JSyntheticImages
from repro.kernels import dbl_merge as JK
from repro_torch.api import ScheduleSpec
from repro_torch.cluster import sync, topology
from repro_torch.cluster.simulator import run_event_loop
from repro_torch.cluster.trace import (_chunk_ranges, schedule_pass,
                                       trace_signature)
from repro_torch.core.dual_batch import solve_plan
from repro_torch.core.time_model import LinearTimeModel
from repro_torch.data import DataPlane, SyntheticImages
from repro_torch.kernels import dbl_merge as K

torch.set_num_threads(1)

INTERPRET_ATOL = 4.8e-7          # ROADMAP C2: jitted XLA:CPU vs eager math
POLICIES = {"bsp": (jsync.BSP(), sync.BSP()), "asp": (jsync.ASP(), sync.ASP()),
            "ssp1": (jsync.SSP(1), sync.SSP(1))}
TRACE_FIELDS = ("worker_id", "lr", "update_factor", "batch_size",
                "stream_step")


def _lr(e):
    return 0.05 if e < 1 else 0.01


def _cluster(pkg, elastic: bool):
    """The setup of the reference's ``engine/parity.py`` trace check (B_L
    and B_S workers, jitter 0.2, a joiner and a leave), built from
    ``pkg``'s classes."""
    W, E = pkg
    workers = [W(8, 16, 1.0, 0.1, 0.2), W(4, 16, 0.8, 0.07, 0.2)]
    events = (E(time=0.25, action="join", worker=W(8, 16, 0.5, 0.1, 0.2)),
              E(time=0.8, action="leave", worker_id=1)) if elastic else ()
    return workers, events


def _plan_workers(pkg_tm, pkg_plan, pkg_topo):
    """Workers from a dual-batch plan under heterogeneous per-worker time
    models and per-worker jitter."""
    tms = [pkg_tm(a=0.001 * (1 + i), b=0.0246 + 0.01 * i) for i in range(3)]
    plan = pkg_plan(tms[0], B_L=8, d=32, n_workers=3, n_small=1, k=1.05)
    return pkg_topo.workers_from_plan(plan, tms, jitter=[0.2, 0.0, 0.3])


def _spec_tuple(w):
    return (w.batch_size, w.data_per_epoch, w.update_factor, w.iter_time,
            w.jitter, w.iters_per_epoch)


def test_sync_policies_match_reference():
    for name, (jp, tp) in POLICIES.items():
        assert tp.name == jp.name and tp.bound() == jp.bound()
        for done, m in [(0, 0), (1, 0), (2, 0), (5, 1), (3, 3)]:
            assert tp.allows(done, m) == jp.allows(done, m), (name, done, m)
    for s in ("bsp", "asp", "ssp"):
        assert sync.as_policy(s, 2) == sync.as_policy(sync.as_policy(s, 2))
        assert sync.as_policy(s, 2).bound() == jsync.as_policy(s, 2).bound()
    with pytest.raises(ValueError, match="unknown sync policy"):
        sync.as_policy("gossip")


def test_workers_from_plan_matches_reference():
    jw = _plan_workers(JLinearTimeModel, jsolve_plan, jtopo)
    tw = _plan_workers(LinearTimeModel, solve_plan, topology)
    assert [_spec_tuple(w) for w in tw] == [_spec_tuple(w) for w in jw]
    assert [w.batch_size for w in tw] == [8, 8, tw[2].batch_size]
    assert tw[2].batch_size < 8 and tw[2].update_factor < 1.0
    with pytest.raises(ValueError, match="3 workers"):
        topology.workers_from_plan(
            solve_plan(LinearTimeModel(0.001, 0.0246), B_L=8, d=32,
                       n_workers=3, n_small=1, k=1.05),
            [LinearTimeModel(0.001, 0.0246)] * 2)
    with pytest.raises(ValueError, match="join event needs"):
        topology.ClusterEvent(time=0.0, action="join")


def _recorded_loop(loop, workers, policy, events):
    """run_event_loop with recording hooks: (sim_time, n_pushes, executed
    events, evals, joins)."""
    executed, evals, joins = [], [], []
    t, n = loop(workers, epochs=2, lr_for_epoch=_lr, policy=policy, seed=7,
                events=events,
                execute=lambda wid, w, lr: executed.append(
                    (wid, w.batch_size, lr)),
                evaluate=lambda e, now: evals.append((e, now)),
                on_join=lambda wid, w: joins.append(wid))
    return t, n, executed, evals, joins


@pytest.mark.parametrize("elastic", [False, True], ids=["static", "elastic"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_timeline_matches_reference(policy, elastic):
    jp, tp = POLICIES[policy]
    jw, je = _cluster((jtopo.WorkerSpec, jtopo.ClusterEvent), elastic)
    tw, te = _cluster((topology.WorkerSpec, topology.ClusterEvent), elastic)
    # the event loop itself: same events in the same order, same clock
    ref = _recorded_loop(jrun_event_loop, jw, jp, je)
    got = _recorded_loop(run_event_loop, tw, tp, te)
    assert got == ref
    assert got[1] == len(got[2]) > 0 and len(got[3]) == 2
    # the schedule pass: the SimTrace field for field
    jt = jschedule_pass(jw, epochs=2, lr_for_epoch=_lr, sync=jp, seed=7,
                        events=je)
    tt = schedule_pass(tw, epochs=2, lr_for_epoch=_lr, sync=tp, seed=7,
                       events=te)
    for f in TRACE_FIELDS:
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (tt.evals, tt.sim_time, tt.n_pushes, tt.n_workers, tt.sizes,
            tt.n_events) == (jt.evals, jt.sim_time, jt.n_pushes,
                             jt.n_workers, jt.sizes, jt.n_events)
    assert tt.sizes == (4, 8) and tt.n_workers == (3 if elastic else 2)
    assert tt.segments() == jt.segments()
    assert np.array_equal(tt.size_class(), jt.size_class())
    for chunk in (1, 3, 4, 32):
        assert _chunk_ranges(tt, chunk) == j_chunk_ranges(jt, chunk)
    assert trace_signature(tt) == jtrace_signature(jt)
    # the heterogeneous, plan-built cluster too
    jh = _plan_workers(JLinearTimeModel, jsolve_plan, jtopo)
    th = _plan_workers(LinearTimeModel, solve_plan, topology)
    jt = jschedule_pass(jh, epochs=2, lr_for_epoch=_lr, sync=jp, seed=3)
    tt = schedule_pass(th, epochs=2, lr_for_epoch=_lr, sync=tp, seed=3)
    assert all(np.array_equal(getattr(tt, f), getattr(jt, f))
               for f in TRACE_FIELDS)
    assert (tt.evals, tt.sim_time, tt.n_pushes) == (jt.evals, jt.sim_time,
                                                    jt.n_pushes)


def _planes():
    kw = dict(scheme="hybrid", input_size=16, batch_size=8, dataset_size=64,
              n_workers=4, n_small=3, k=1.05, epochs=2, lr=0.05,
              sub_sizes=(8, 16), sub_dropouts=(0.0, 0.0),
              stage_epochs=(1, 1), stage_lrs=(0.05, 0.01), seed=0)
    src = dict(n_train=128, n_test=16, num_classes=10, seed=0)
    jph, tph = JScheduleSpec(**kw).to_phases(), ScheduleSpec(**kw).to_phases()
    jplane = JDataPlane(JSyntheticImages(**src), seed=5).bind(jph)
    tplane = DataPlane(SyntheticImages(**src), seed=5).bind(tph)
    return jph, tph, jplane, tplane


def test_sim_data_fn_matches_reference_plane():
    jph, tph, jplane, tplane = _planes()
    for pi, (jphase, tphase) in enumerate(zip(jph, tph)):
        jdf = jplane.sim_data_fn(pi, jphase)
        tdf = tplane.sim_data_fn(pi, tphase, "cpu")
        # event order interleaves the workers; each keeps its own counter
        for wid, bsz in [(3, 2), (0, 8), (3, 2), (1, 3), (0, 8), (3, 2)]:
            jb, tb = jdf(None, wid, bsz), tdf(None, wid, bsz)
            for k in jb:
                assert tb[k].device.type == "cpu"
                assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k


def test_trace_feed_matches_reference_plane():
    jph, tph, jplane, tplane = _planes()
    workers, events = _cluster((topology.WorkerSpec, topology.ClusterEvent),
                               True)
    trace = schedule_pass(workers, epochs=2, lr_for_epoch=_lr, sync="asp",
                          seed=7, events=events)
    ranges = _chunk_ranges(trace, 4)
    n = 0
    for pi, (jphase, tphase) in enumerate(zip(jph, tph)):
        for prefetch in (False, True):
            jfeed = jplane.trace_feed(pi, jphase, prefetch=prefetch)
            tfeed = tplane.trace_feed(pi, tphase, "cpu", prefetch=prefetch)
            for (e0, e1), jb, tb in zip(ranges, jfeed(trace, ranges),
                                        tfeed(trace, ranges)):
                for k in jb:
                    assert tb[k].shape[:2] == (e1 - e0, 8)
                    assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
                n += 1
    tplane.close()
    assert n == 4 * len(ranges)


def test_simulator_batches_are_contiguous_nhwc():
    """Both simulator paths hand the model NHWC-contiguous images: a
    resized batch used to keep ``np.stack``'s W-major layout on the event
    path, where cuDNN then ran other kernels than on the traced replay's
    staged (contiguous) copy of the same values (ROADMAP C6)."""
    _, tph, _, tplane = _planes()
    workers, _ = _cluster((topology.WorkerSpec, topology.ClusterEvent),
                          False)
    trace = schedule_pass(workers, epochs=1, lr_for_epoch=_lr, sync="asp",
                          seed=7)
    ranges = _chunk_ranges(trace, 4)[:1]
    for pi, phase in enumerate(tph):
        ev = tplane.sim_data_fn(pi, phase, "cpu")(None, 1, 3)
        tr = next(iter(tplane.trace_feed(pi, phase, "cpu",
                                         prefetch=False)(trace, ranges)))
        for k in ev:
            assert ev[k].is_contiguous() and tr[k][0].is_contiguous(), k
        assert ev["images"].shape[1:] == (phase.input_size,) * 2 + (3,)
        assert tplane(phase, tplane._starts[pi])["images"].flags[
            "C_CONTIGUOUS"]


# --------------------------------------------------------------- kernel B3
LR, FACTOR, MOM = 0.05, 0.9365079365079365, 0.9


def _b3_inputs(rows, n_workers, seed):
    rs = np.random.RandomState(seed)
    return {"p": rs.randn(rows, 128).astype(np.float32),
            "g": rs.randn(rows, 128).astype(np.float32),
            "v": rs.randn(n_workers, rows, 128).astype(np.float32)}


def _run_port(x, wid, master, plain: bool):
    p = torch.from_numpy(x["p"].copy())
    g = torch.from_numpy(x["g"])
    v = torch.from_numpy(x["v"].copy())
    fn = K.dbl_apply_worker_plain if plain else K.dbl_apply_worker_flat2d
    if master:
        sh = p.to(torch.bfloat16)
        fn(sh, g, v, wid, LR, FACTOR, MOM, master2=p)
        return {"shadow": sh, "p": p, "v": v}
    fn(p, g, v, wid, LR, FACTOR, MOM)
    return {"p": p, "v": v}


def _run_ref(x, wid, master, interpret: bool):
    p, g, v = (jnp.asarray(x[k]) for k in ("p", "g", "v"))
    scal = (jnp.int32(wid), jnp.float32(LR), jnp.float32(FACTOR),
            jnp.float32(MOM))
    if interpret:
        kw = {"master2": p} if master else {}
        out = JK.dbl_apply_worker_flat2d(
            p.astype(jnp.bfloat16) if master else p, g, v, *scal,
            interpret=True, **kw)
    else:
        out = JK.dbl_apply_worker_xla(
            p.astype(jnp.bfloat16) if master else p, g, v, *scal,
            master2=p if master else None)
    names = ("shadow", "p", "v") if master else ("p", "v")
    return dict(zip(names, (np.asarray(o.astype(jnp.float32))
                            for o in out)))


@pytest.mark.parametrize("rows,n_workers", [(64, 3), (3072, 4)])
@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_b3_plain_matches_reference(master, rows, n_workers):
    x = _b3_inputs(rows, n_workers, seed=rows + n_workers)
    wid = n_workers - 2
    K.reset_counts()
    got = _run_port(x, wid, master, plain=False)
    variant = "master" if master else "plain"
    assert K.plain_count("dbl_apply_worker_flat2d", variant) == 1
    assert K.plain_count() == 1 and K.launch_count() == 0
    eager = _run_ref(x, wid, master, interpret=False)
    interp = _run_ref(x, wid, master, interpret=True)
    for name in eager:
        t = got[name].float().numpy()
        assert np.array_equal(t, eager[name]), name          # bit for bit
        gap = np.abs(t - interp[name])
        if name == "shadow":
            # a master a few ulp off may round to the neighbouring bf16
            # value: one bf16 ulp (8 significant bits) at most
            ulp = np.exp2(np.floor(np.log2(np.maximum(
                np.abs(got["p"].numpy()), 1e-30))) - 7)
            assert np.all(gap <= ulp), name
        else:
            assert float(np.max(gap)) <= INTERPRET_ATOL, name
    if master:
        assert torch.equal(got["shadow"], got["p"].to(torch.bfloat16))
    for i in range(n_workers):
        if i != wid:
            assert np.array_equal(got["v"][i].numpy(), x["v"][i])
    assert not np.array_equal(got["v"][wid].numpy(), x["v"][wid])
    # the plain version called by name is the same function
    direct = _run_port(x, wid, master, plain=True)
    assert all(torch.equal(direct[k], got[k]) for k in got)


def test_b3_wrapper_refuses_bad_arguments():
    p, g = torch.zeros(8, 128), torch.zeros(8, 128)
    v = torch.zeros(2, 8, 128)
    with pytest.raises(TypeError, match="host number"):
        K.dbl_apply_worker_flat2d(p, g, v, torch.tensor(0), LR, FACTOR, MOM)
    with pytest.raises(TypeError, match="host number"):
        K.dbl_apply_worker_flat2d(p, g, v, 0, torch.tensor(LR), FACTOR, MOM)
    for wid in (-1, 2, 0.5):
        with pytest.raises(ValueError, match="outside"):
            K.dbl_apply_worker_flat2d(p, g, v, wid, LR, FACTOR, MOM)
    with pytest.raises(ValueError, match="stacked velocity"):
        K.dbl_apply_worker_flat2d(p, g, torch.zeros(2, 16, 128), 0, LR,
                                  FACTOR, MOM)
    meta = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="no dbl_apply_worker_flat2d"):
        K.dbl_apply_worker_flat2d(meta, meta, torch.zeros(2, 8, 128,
                                                          device="meta"),
                                  np.int32(1), np.float32(LR), FACTOR, MOM)
