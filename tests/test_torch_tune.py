"""The port's schedule autotuner (``repro_torch.tune``) and batched
candidate replay (``execute_trace_batched``) against the JAX package and
against the port's own sequential replay.

* Host arithmetic, exactly: ``SearchSpace`` and the table builders give the
  reference's labels and ``spec.to_json()`` strings (star and product),
  ``predicted_schedule_time`` / ``schedule_cost`` its floats, the analytic
  ``autotune(..., validate=False).to_json()`` its bytes, ``dominates`` /
  ``pareto_front`` its answers on seeded random objective sets.
* B3's candidate-batched plain form (``dbl_apply_worker_batched_plain``,
  what the wrapper runs for CPU tensors) is bit-equal to C plain B3 calls
  and to eager ``jax.vmap(dbl_apply_worker_xla)``, and within
  ``INTERPRET_ATOL`` of its jitted form (ROADMAP C2).
* The batched replay is held bit for bit to the port's OWN sequential
  ``execute_trace``, per candidate (a shared feed, per-candidate feeds,
  the bf16 store, a shared ``data_fn``), on a torch twin of
  ``tests/test_tune.py``'s bigram problem and on a width-8 ResNet-18 at 8
  px; to the reference's sequential replay only
  within ``INTERPRET_ATOL`` (the reference's own batched replay is 1-2 ulp
  off its sequential one, ROADMAP C1).  Planted faults (two candidates'
  scalars swapped, one velocity shared by two candidates) break both.
* ``autotune`` end to end on the bigram problem: the reference's labels,
  pruning, replay tags, ``sim_time``s, accuracies and front, test losses
  within ``LOSS_BAND``, and the same result twice.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.api import RunConfig as JRunConfig
from repro.api import ScheduleSpec as JScheduleSpec
from repro.cluster.trace import execute_trace as jexecute_trace
from repro.core.flat import flat_spec as jflat_spec
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.kernels import dbl_merge as JK
from repro.tune.autotune import _single_phase_trace as _jsingle_phase_trace
from repro_torch import models, tune
from repro_torch.api import RunConfig, ScheduleSpec
from repro_torch.cluster import trace as trace_mod
from repro_torch.cluster.trace import (execute_trace, execute_trace_batched,
                                       trace_signature)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.flat import flat_spec
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataPlane, SyntheticImages, SyntheticTokens
from repro_torch.kernels import dbl_merge as K
from repro_torch.tune.autotune import Candidate, _single_phase_trace

torch.set_num_threads(1)

INTERPRET_ATOL = 4.8e-7          # ROADMAP C2: jitted XLA:CPU vs eager math
# eval test losses of the port vs the reference on the bigram problem:
# measured at most 2.4e-7, one f32 ulp of the losses (about 2.42); four ulp
LOSS_BAND = 1e-6


def _spaces(pkg):
    t = pkg
    base8 = t.base_spec(epochs=6)
    return {
        "combined6": t.combined_space(epochs=6),
        "combined4": t.combined_space(epochs=4, seed=0),
        "table3": t.table3_space(),
        "table5": t.table5_space(),
        "table8": t.table8_space(),
        "table3_on_base": t.table3_space(base=base8),
        "other_axes": t.SearchSpace(base=base8, cycles=(1, 3),
                                    n_workers=(2, 8), sync=("bsp", "ssp"),
                                    seeds=(1, 2), ladders=((),)),
        "product": t.SearchSpace(base=base8, n_small=(1, 2), k=(1.1, 1.2),
                                 factor=("sqrt",), ladders=((24, 32), ()),
                                 mode="product"),
        "width8": t.SearchSpace(
            base=t.base_spec(epochs=2, input_size=8, dataset_size=64,
                             batch_size=8),
            n_small=(0, 1, 2, 4), factor=("sqrt", "none"), k=(1.1, 1.5),
            ladders=((4, 8),)),
    }


@pytest.mark.parametrize("name", list(_spaces(tune)))
def test_search_space_matches_reference(name):
    port, ref = _spaces(tune)[name], _spaces(jtune)[name]
    got = [(lb, sp.to_json()) for lb, sp in port.candidates()]
    want = [(lb, sp.to_json()) for lb, sp in ref.candidates()]
    assert got == want
    assert len({sp for _, sp in port.candidates()}) == len(got)


def test_union_candidates_matches_reference():
    def union(t):
        base = t.base_spec(epochs=6)
        return t.union_candidates(t.table3_space(base=base),
                                  t.table5_space(base=base),
                                  t.table8_space(base=base))
    assert [(lb, sp.to_json()) for lb, sp in union(tune)] \
        == [(lb, sp.to_json()) for lb, sp in union(jtune)]


def test_search_space_refuses_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        tune.SearchSpace(base=tune.base_spec(), k=(1.1,),
                         mode="grid").candidates()


def _sample_specs(t, spec_cls):
    """``tests/test_tune.py``'s sample specs, built by either package."""
    return [
        t.base_spec(),
        t.base_spec(epochs=6, n_small=0),
        t.base_spec(seed=7).replace(k=1.1, factor="sqrt"),
        t.base_spec(epochs=16).replace(scheme="hybrid", sub_sizes=(24, 32),
                                       sub_dropouts=(0.0, 0.1),
                                       lr_stage_epochs=(), lr_stage_lrs=()),
        spec_cls(scheme="dbl", input_size=8, axis="seq_len",
                 batch_size=16, dataset_size=512, n_workers=4,
                 n_small=3, n_steps=100, lr=0.3, micro_steps=2,
                 tm_a=1.0, tm_b=24.57, seed=3),
    ]


@pytest.mark.parametrize("i", range(5))
def test_pricing_matches_reference(i):
    port = _sample_specs(tune, ScheduleSpec)[i]
    ref = _sample_specs(jtune, JScheduleSpec)[i]
    assert port.to_json() == ref.to_json()
    assert tune.predicted_schedule_time(port) \
        == jtune.predicted_schedule_time(ref)
    assert tune.schedule_cost(port) == jtune.schedule_cost(ref)


@pytest.mark.parametrize("epochs,key", [(6, None), (4, "f27f41f24570")])
def test_analytic_autotune_json_matches_reference(epochs, key):
    port = tune.autotune(tune.combined_space(epochs=epochs), problem=None,
                         validate=False, budget_ratio=1.5)
    ref = jtune.autotune(jtune.combined_space(epochs=epochs), problem=None,
                         validate=False, budget_ratio=1.5)
    assert port.to_json() == ref.to_json()           # byte for byte
    assert [c.label for c in port.candidates if c.pruned] == ["k1.5"]
    assert port.front == [] and not any(c.validated
                                        for c in port.candidates)
    if key is not None:
        assert port.run_key() == key


@pytest.mark.parametrize("seed", range(4))
def test_pareto_matches_reference(seed):
    rs = np.random.RandomState(seed)
    n = 12
    objs = np.stack([rs.uniform(1, 2, n), rs.uniform(1, 2, n),
                     rs.uniform(0.3, 0.6, n)], axis=1)
    objs[3] = objs[2] * [1.01, 1.0, 1.0]             # ties inside the noise
    objs[5] = objs[4] + [0.0, 0.0, 0.02]
    objs = [tuple(float(x) for x in o) for o in objs]
    eps = dict(acc_eps=0.03 * seed, rel_eps=0.01 * seed)
    for a in objs:
        for b in objs:
            assert tune.dominates(a, b, **eps) == \
                jtune.dominates(a, b, **eps)

    def cands(t, spec):
        out = []
        for i, (tm, c, a) in enumerate(objs):
            cd = t.Candidate(label=f"c{i}", spec=spec, predicted_time=tm,
                             cost=c)
            if i % 5 != 4:                           # some unvalidated
                cd.sim_time, cd.accuracy = tm, a
            cd.pruned = i == 7
            out.append(cd)
        return out
    port = tune.pareto_front(cands(tune, tune.base_spec()), **eps)
    assert port == jtune.pareto_front(cands(jtune, jtune.base_spec()), **eps)
    assert port


def test_zeros_candidates_matches_reference():
    tree = {"a": np.zeros((3, 5), np.float32), "b": np.zeros((7,),
                                                              np.float32)}
    spec = flat_spec(params_from_numpy(tree, "cpu"))
    z = spec.zeros_candidates(3, 4, device="cpu")
    ref = jflat_spec(jax.tree_util.tree_map(jnp.asarray, tree)
                     ).zeros_candidates(3, 4)
    assert tuple(z.shape) == tuple(ref.shape) == (3, 4) + spec.shape
    assert z.dtype == torch.float32 and z.device.type == "cpu"
    assert not z.any()


# ---------------------------------------------------- B3's batched form
LR = (0.05, 0.01, 0.3)
FAC = (0.9365079365079365, 1.0, 0.5)
MOM = (0.9, 0.0, 0.5)


def _batched_inputs(n_cand, n_workers, rows, seed):
    rs = np.random.RandomState(seed)
    return {"p": rs.randn(n_cand, rows, 128).astype(np.float32),
            "g": rs.randn(n_cand, rows, 128).astype(np.float32),
            "v": rs.randn(n_cand, n_workers, rows, 128).astype(np.float32),
            "lr": np.array(LR[:n_cand], np.float32),
            "f": np.array(FAC[:n_cand], np.float32),
            "m": np.array(MOM[:n_cand], np.float32)}


def _run_batched(x, wid, master, form):
    p = torch.from_numpy(x["p"].copy())
    g = torch.from_numpy(x["g"])
    v = torch.from_numpy(x["v"].copy())
    scal = [torch.from_numpy(x[k]) for k in ("lr", "f", "m")]
    sh = p.to(torch.bfloat16) if master else None
    if form == "calls":                  # C plain B3 calls, host scalars
        for c in range(p.shape[0]):
            args = (g[c], v[c], wid, x["lr"][c], x["f"][c], x["m"][c])
            if master:
                K.dbl_apply_worker_plain(sh[c], *args, master2=p[c])
            else:
                K.dbl_apply_worker_plain(p[c], *args)
    else:
        fn = (K.dbl_apply_worker_batched if form == "wrapper"
              else K.dbl_apply_worker_batched_plain)
        if master:
            fn(sh, g, v, wid, *scal, masterC=p)
        else:
            fn(p, g, v, wid, *scal)
    out = {"p": p, "v": v}
    if master:
        out["shadow"] = sh
    return out


def _run_batched_ref(x, wid, master, jit):
    p, g, v = (jnp.asarray(x[k]) for k in ("p", "g", "v"))
    scal = [jnp.asarray(x[k]) for k in ("lr", "f", "m")]
    fn = jax.vmap(JK.dbl_apply_worker_xla,
                  in_axes=(0, 0, 0, None, 0, 0, 0, 0 if master else None))
    if jit:
        fn = jax.jit(fn)
    out = fn(p.astype(jnp.bfloat16) if master else p, g, v, jnp.int32(wid),
             *scal, p if master else None)
    names = ("shadow", "p", "v") if master else ("p", "v")
    return dict(zip(names, (np.asarray(o.astype(jnp.float32))
                            for o in out)))


@pytest.mark.parametrize("n_cand,n_workers,rows", [(1, 3, 64), (3, 4, 64),
                                                   (3, 3, 2048)])
@pytest.mark.parametrize("master", [False, True], ids=["plain", "master"])
def test_batched_b3_plain_matches_reference(master, n_cand, n_workers, rows):
    x = _batched_inputs(n_cand, n_workers, rows, seed=rows + n_cand)
    wid = n_workers - 2
    K.reset_counts()
    got = _run_batched(x, wid, master, "wrapper")
    variant = "master" if master else "plain"
    assert K.plain_count("dbl_apply_worker_batched", variant) == 1
    assert K.plain_count("dbl_apply_worker_flat2d") == 0
    assert K.launch_count() == 0
    calls = _run_batched(x, wid, master, "calls")
    direct = _run_batched(x, wid, master, "plain")
    for k in got:
        assert torch.equal(got[k], calls[k]), k           # C plain calls
        assert torch.equal(got[k], direct[k]), k
    eager = _run_batched_ref(x, wid, master, jit=False)
    jitted = _run_batched_ref(x, wid, master, jit=True)
    for name in eager:
        t = got[name].float().numpy()
        assert np.array_equal(t, eager[name]), name       # bit for bit
        if name != "shadow":
            assert float(np.abs(t - jitted[name]).max()) <= INTERPRET_ATOL
    if master:
        assert torch.equal(got["shadow"], got["p"].to(torch.bfloat16))
    for c in range(n_cand):
        for i in range(n_workers):
            same = np.array_equal(got["v"][c, i].numpy(), x["v"][c, i])
            assert same == (i != wid), (c, i)


def test_batched_b3_uses_each_candidates_scalars():
    """Candidate c's result depends on lrC[c], facC[c] and momC[c] alone:
    the form that gave every candidate candidate 0's scalars differs."""
    x = _batched_inputs(3, 2, 64, seed=5)
    got = _run_batched(x, 1, False, "wrapper")
    x0 = dict(x, **{k: np.repeat(x[k][:1], 3) for k in ("lr", "f", "m")})
    wrong = _run_batched(x0, 1, False, "wrapper")
    assert torch.equal(got["p"][0], wrong["p"][0])
    for c in (1, 2):
        assert not torch.equal(got["p"][c], wrong["p"][c])
        assert not torch.equal(got["v"][c, 1], wrong["v"][c, 1])


def test_batched_b3_wrapper_refuses_bad_arguments():
    p, g = torch.zeros(2, 8, 128), torch.zeros(2, 8, 128)
    v = torch.zeros(2, 3, 8, 128)
    s = torch.zeros(2)
    fn = K.dbl_apply_worker_batched
    with pytest.raises(ValueError, match="lrC must be"):
        fn(p, g, v, 0, 0.1, s, s)
    with pytest.raises(ValueError, match="momC must be"):
        fn(p, g, v, 0, s, s, torch.zeros(3))
    with pytest.raises(ValueError, match="facC must be"):
        fn(p, g, v, 0, s, s.double(), s)
    with pytest.raises(TypeError, match="host number"):
        fn(p, g, v, torch.tensor(0), s, s, s)
    for wid in (-1, 3, 0.5):
        with pytest.raises(ValueError, match="outside"):
            fn(p, g, v, wid, s, s, s)
    with pytest.raises(ValueError, match="candidate velocity"):
        fn(p, g, torch.zeros(3, 3, 8, 128), 0, s, s, s)
    with pytest.raises(ValueError, match="candidate buffers"):
        fn(p[0], g[0], v, 0, s, s, s)
    with pytest.raises(ValueError, match="shape"):
        fn(p, torch.zeros(2, 16, 128), v, 0, s, s, s)
    with pytest.raises(ValueError, match="contiguous"):
        fn(p, g.transpose(1, 2).contiguous().transpose(1, 2), v, 0, s, s, s)
    with pytest.raises(ValueError, match="candidates outside"):
        e = torch.zeros(0, 8, 128)
        fn(e, e, torch.zeros(0, 3, 8, 128), 0, s[:0], s[:0], s[:0])
    with pytest.raises(ValueError, match="bf16 shadow"):
        fn(p, g, v, 0, s, s, s, masterC=p.clone())
    meta = lambda *sh: torch.zeros(*sh, device="meta")
    with pytest.raises(ValueError, match="no dbl_apply_worker_batched"):
        fn(meta(2, 8, 128), meta(2, 8, 128), meta(2, 3, 8, 128), 1,
           meta(2), meta(2), meta(2))


# ------------------------------------------- the bigram problem (both)
VOCAB, NCLS, N_TRAIN, SEQ = 16, 4, 128, 8


def _w0(seed):
    """``tests/test_tune.py``'s initial weights, as numpy."""
    return np.asarray(0.01 * jax.random.normal(
        jax.random.PRNGKey(seed), (VOCAB, VOCAB), jnp.float32))


def _ref_lin_problem():
    """``tests/test_tune.py``'s ``_lin_problem``: bigram softmax
    regression over SyntheticTokens, jitted gradient."""
    inits, planes, fns = {}, {}, {}

    def source(seed):
        return JSyntheticTokens(vocab=VOCAB, num_classes=NCLS, seed=seed,
                                n_examples=N_TRAIN)

    def init_for(seed):
        if seed not in inits:
            inits[seed] = {"w": jnp.asarray(_w0(seed))}
        return inits[seed]

    def plane_for(seed):
        if seed not in planes:
            planes[seed] = JDataPlane(source(seed), seed=seed)
        return planes[seed]

    def fns_for(seed, size):
        if (seed, size) not in fns:
            src = source(seed)

            def loss(p, b):
                oh = jax.nn.one_hot(b["tokens"], VOCAB)
                logp = jax.nn.log_softmax(oh @ p["w"])
                return -jnp.take_along_axis(
                    logp, b["labels"][..., None], axis=-1).mean()

            test = {k: jnp.asarray(v) for k, v in
                    src.batch_at(np.arange(N_TRAIN, N_TRAIN + 64),
                                 size).items()}

            def eval_fn(p):
                logits = jax.nn.one_hot(test["tokens"], VOCAB) @ p["w"]
                acc = float((logits.argmax(-1) == test["labels"]).mean())
                return {"test_loss": float(loss(p, test)), "test_acc": acc}
            fns[(seed, size)] = (jax.jit(jax.grad(loss)), None, eval_fn)
        return fns[(seed, size)]
    return jtune.TuneProblem(init_for=init_for, fns_for=fns_for,
                             plane_for=plane_for)


def _lin_loss(p, b):
    oh = torch.nn.functional.one_hot(b["tokens"].long(), VOCAB).float()
    logp = torch.log_softmax(oh @ p["w"], dim=-1)
    return -torch.gather(logp, -1, b["labels"].long()[..., None]).mean()


def _lin_grad(p, b):
    w = p["w"].detach().requires_grad_()
    return {"w": torch.autograd.grad(_lin_loss({"w": w}, b), w)[0]}


def _lin_problem(device="cpu"):
    """The torch twin of ``_ref_lin_problem``: the same loss, data and
    initial weights (numpy), gradients by autograd on ``device``."""
    inits, planes, fns = {}, {}, {}

    def source(seed):
        return SyntheticTokens(vocab=VOCAB, num_classes=NCLS, seed=seed,
                               n_examples=N_TRAIN)

    def init_for(seed):
        if seed not in inits:
            inits[seed] = {"w": torch.tensor(_w0(seed), device=device)}
        return inits[seed]

    def plane_for(seed):
        if seed not in planes:
            planes[seed] = DataPlane(source(seed), seed=seed)
        return planes[seed]

    def fns_for(seed, size):
        if (seed, size) not in fns:
            test = {k: torch.from_numpy(v).to(device) for k, v in
                    source(seed).batch_at(np.arange(N_TRAIN, N_TRAIN + 64),
                                          size).items()}

            def eval_fn(p):
                with torch.no_grad():
                    oh = torch.nn.functional.one_hot(
                        test["tokens"].long(), VOCAB).float()
                    acc = float((torch.argmax(oh @ p["w"], -1)
                                 == test["labels"]).float().mean())
                    return {"test_loss": float(_lin_loss(p, test)),
                            "test_acc": acc}
            fns[(seed, size)] = (_lin_grad, None, eval_fn)
        return fns[(seed, size)]
    return tune.TuneProblem(init_for=init_for, fns_for=fns_for,
                            plane_for=plane_for)


def _lin_spec(spec_cls=ScheduleSpec, seed=0, **overrides):
    spec = spec_cls(
        scheme="dbl", input_size=SEQ, axis="seq_len", batch_size=16,
        dataset_size=N_TRAIN, n_workers=4, n_small=3, k=1.05, epochs=2,
        lr=0.5, tm_a=0.001, tm_b=0.0246, sync="asp", seed=seed)
    return spec.replace(**overrides) if overrides else spec


def _lin_candidates(spec_cls=ScheduleSpec):
    return [("base", _lin_spec(spec_cls)),
            ("f_sqrt", _lin_spec(spec_cls, factor="sqrt")),
            ("f_none", _lin_spec(spec_cls, factor="none")),
            ("decoy", _lin_spec(spec_cls, k=2.0))]


def _group(specs):
    cands = [Candidate(label=str(i), spec=s) for i, s in enumerate(specs)]
    traces = [_single_phase_trace(c) for c in cands]
    assert len({trace_signature(t) for t in traces}) == 1
    return cands, traces


_LIN_SOURCE = SyntheticTokens(vocab=VOCAB, num_classes=NCLS, seed=0,
                              n_examples=N_TRAIN)


def _lin_data_fn(rng, wid, bsz):
    """The ``data_fn(rng, wid, bsz)`` contract: draws from the generator the
    replay seeds and shares across events (``data_fn_feed``)."""
    b = _LIN_SOURCE.batch_at(rng.integers(0, N_TRAIN, size=bsz), SEQ)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _lin_group(form):
    """(problem, specs, traces, inits, ``feed_of(seed)``) of a
    same-timeline group of the bigram problem: the factor ablation on one
    seed (``shared``, ``bf16``, ``data_fn``) or the base spec on seeds 0,
    1, 2 (``feeds``)."""
    problem = _lin_problem()
    if form == "feeds":
        specs = [_lin_spec(seed=s) for s in (0, 1, 2)]
    else:
        specs = [sp for _, sp in _lin_candidates()[:3]]
    cands, traces = _group(specs)
    inits = [problem.init_for(s.seed) for s in specs]
    phase = specs[0].to_phases()[0]

    def feed_of(seed):
        return problem.plane_for(seed).trace_feed(0, phase, "cpu")
    return problem, specs, traces, inits, feed_of


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def _lin_batched(form, **kw):
    problem, specs, traces, inits, feed_of = _lin_group(form)
    grad_fn, _, _ = problem.fns_for(0, SEQ)
    eval_fns = [problem.fns_for(s.seed, SEQ)[2] for s in specs]
    feeds = {"feeds": dict(feeds=[feed_of(s.seed) for s in specs]),
             "data_fn": dict(data_fn=_lin_data_fn, seed=0)}.get(
                 form, dict(feed=feed_of(0)))
    return execute_trace_batched(
        inits, grad_fn, traces, eval_fns=eval_fns, scan_chunk=8,
        precision="bf16" if form == "bf16" else "f32", **feeds, **kw)


@pytest.mark.parametrize("form", ["shared", "feeds", "bf16", "data_fn"])
def test_batched_replay_bit_identical_to_own_sequential(form):
    problem, specs, traces, inits, feed_of = _lin_group(form)
    grad_fn, _, _ = problem.fns_for(0, SEQ)
    K.reset_counts()
    bat = _lin_batched(form)
    n_ev = traces[0].n_events
    variant = "master" if form == "bf16" else "plain"
    assert n_ev == 24
    assert K.plain_count("dbl_apply_worker_batched", variant) == n_ev
    assert K.plain_count("dbl_apply_worker_flat2d") == 0
    for s, tr, p0, b in zip(specs, traces, inits, bat):
        data = dict(data_fn=_lin_data_fn, seed=0) if form == "data_fn" \
            else dict(feed=feed_of(s.seed))
        seq = execute_trace(p0, grad_fn, tr, **data,
                            eval_fn=problem.fns_for(s.seed, SEQ)[2],
                            scan_chunk=8,
                            precision="bf16" if form == "bf16" else "f32")
        assert (b.sim_time, b.n_pushes) == (seq.sim_time, seq.n_pushes)
        assert b.history == seq.history
        assert all(t.dtype == torch.float32 for t in tree_leaves(b.params))
        assert _leaves_equal(b.params, seq.params)
    # the candidates really differ (factors, or seeds and data)
    assert not torch.equal(bat[0].params["w"], bat[1].params["w"])
    assert float(bat[0].params["w"].abs().max()) > 1.0


def _ref_sequential(traces):
    problem = _ref_lin_problem()
    grad_fn, _, _ = problem.fns_for(0, SEQ)
    phase = _lin_spec(JScheduleSpec).to_phases()[0]
    return [np.asarray(jexecute_trace(
        problem.init_for(0), grad_fn, tr,
        feed=problem.plane_for(0).trace_feed(0, phase),
        scan_chunk=8).params["w"]) for tr in traces]


def test_batched_replay_within_band_of_reference():
    bat = _lin_batched("shared")
    jspecs = [sp for _, sp in _lin_candidates(JScheduleSpec)[:3]]
    jtraces = [_jsingle_phase_trace(jtune.Candidate(label="", spec=s))
               for s in jspecs]
    ref = _ref_sequential(jtraces)
    for b, r in zip(bat, ref):
        assert float(np.abs(b.params["w"].numpy() - r).max()) \
            <= INTERPRET_ATOL


def _swap_factors(real):
    def fault(pC, gC, velC, wid, lrC, facC, momC, masterC=None):
        return real(pC, gC, velC, wid, lrC, facC.flip(0), momC,
                    masterC=masterC)
    return fault


def _shared_velocity(real):
    def fault(pC, gC, velC, wid, lrC, facC, momC, masterC=None):
        out = real(pC, gC, velC, wid, lrC, facC, momC, masterC=masterC)
        velC[1, wid].copy_(velC[0, wid])     # candidate 1 reads 0's next
        return out
    return fault


@pytest.mark.parametrize("fault", [_swap_factors, _shared_velocity],
                         ids=["scalars_swapped", "velocity_shared"])
def test_planted_faults_break_the_limits(fault, monkeypatch):
    good = _lin_batched("shared")
    monkeypatch.setattr(trace_mod, "dbl_apply_worker_batched",
                        fault(K.dbl_apply_worker_batched))
    bad = _lin_batched("shared")
    jspecs = [sp for _, sp in _lin_candidates(JScheduleSpec)[:3]]
    ref = _ref_sequential([_jsingle_phase_trace(
        jtune.Candidate(label="", spec=s)) for s in jspecs])
    gaps = [float(np.abs(b.params["w"].numpy() - r).max())
            for b, r in zip(bad, ref)]
    assert max(gaps) > 100 * INTERPRET_ATOL, gaps
    assert not all(_leaves_equal(b.params, g.params)
                   for b, g in zip(bad, good))


def test_batched_replay_refusals():
    problem, specs, traces, inits, feed_of = _lin_group("shared")
    grad_fn = problem.fns_for(0, SEQ)[0]
    other = _single_phase_trace(Candidate(label="k1.5",
                                          spec=_lin_spec(k=1.5)))
    assert trace_signature(other) != trace_signature(traces[0])
    with pytest.raises(ValueError, match="different signature"):
        execute_trace_batched(inits[:2], grad_fn, [traces[0], other],
                              feed=feed_of(0))
    with pytest.raises(ValueError, match="2 feeds for 3 traces"):
        execute_trace_batched(inits, grad_fn, traces,
                              feeds=[feed_of(0)] * 2)
    with pytest.raises(ValueError, match="2 init params for 3 traces"):
        execute_trace_batched(inits[:2], grad_fn, traces, feed=feed_of(0))
    with pytest.raises(ValueError, match="needs feed, feeds or a data_fn"):
        execute_trace_batched(inits, grad_fn, traces)
    with pytest.raises(ValueError, match="unknown precision"):
        execute_trace_batched(inits, grad_fn, traces, feed=feed_of(0),
                              precision="fp8")
    assert execute_trace_batched([], grad_fn, []) == []


def _search(pkg, problem, **kw):
    spec_cls = ScheduleSpec if pkg is tune else JScheduleSpec
    config = (RunConfig if pkg is tune else JRunConfig)(trace_chunk=8)
    return pkg.autotune(_lin_candidates(spec_cls), problem, config=config,
                        budget_ratio=1.5, **kw)


def _summary(res):
    return [(c.label, c.pruned, c.replay, c.sim_time, c.accuracy)
            for c in res.candidates]


def test_autotune_matches_reference():
    port = _search(tune, _lin_problem(), device="cpu")
    again = _search(tune, _lin_problem(), device="cpu")
    ref = _search(jtune, _ref_lin_problem())
    assert _summary(port) == _summary(ref)
    assert port.front == ref.front and port.front
    assert [c.replay for c in port.candidates] == ["batched:3"] * 3 + [""]
    assert port.run_key() == ref.run_key()
    for a, b in zip(port.candidates, ref.candidates):
        if b.test_loss is None:
            assert a.test_loss is None
        else:
            assert abs(a.test_loss - b.test_loss) <= LOSS_BAND
    assert [dataclasses.astuple(c) for c in port.candidates] \
        == [dataclasses.astuple(c) for c in again.candidates]
    assert port.to_json() == again.to_json()


def test_autotune_api_path_and_devices():
    """Single-member groups replay through ``api.run``; params off the
    search's device are refused on both paths."""
    problem = _lin_problem()
    cands = [("base", _lin_spec()), ("k1.2", _lin_spec(k=1.2))]
    res = tune.autotune(cands, problem, config=RunConfig(trace_chunk=8),
                        device="cpu")
    assert [c.replay for c in res.candidates] == ["api", "api"]
    assert all(c.validated for c in res.candidates)
    meta = tune.TuneProblem(
        init_for=lambda s: {"w": torch.zeros(VOCAB, VOCAB, device="meta")},
        fns_for=problem.fns_for, plane_for=problem.plane_for)
    with pytest.raises(ValueError, match="search runs on cpu"):
        tune.autotune(_lin_candidates()[:3], meta, device="cpu")
    with pytest.raises(ValueError, match="params live on meta"):
        tune.autotune(cands[:1], meta, device="cpu")


# ------------------------------------ width-8 ResNet-18, a group of three
RES_SRC = dict(n_train=128, n_test=16, num_classes=10, seed=0)


def test_resnet_group_batched_bit_equal_to_sequential():
    from repro_torch.examples.train_resnet18_e2e import make_fns_factory
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    data = SyntheticImages(**RES_SRC)
    fns = make_fns_factory(cfg, data, "cpu")
    base = tune.base_spec(epochs=1, input_size=8, dataset_size=64,
                          batch_size=8)
    specs = [base, base.replace(factor="sqrt"), base.replace(factor="none")]
    _, traces = _group(specs)
    assert traces[0].n_events == 12
    p0 = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    grad_fn, _, eval_fn = fns(8)
    plane = DataPlane(data, seed=0)
    phase = specs[0].to_phases()[0]
    K.reset_counts()
    bat = execute_trace_batched([p0] * 3, grad_fn, traces,
                                feed=plane.trace_feed(0, phase, "cpu"),
                                eval_fn=eval_fn)
    assert K.plain_count("dbl_apply_worker_batched") == traces[0].n_events
    for tr, b in zip(traces, bat):
        seq = execute_trace(p0, grad_fn, tr, eval_fn=eval_fn,
                            feed=plane.trace_feed(0, phase, "cpu"))
        assert b.history == seq.history
        assert _leaves_equal(b.params, seq.params)
    assert not _leaves_equal(bat[0].params, bat[2].params)
