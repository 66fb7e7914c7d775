"""Host-side parity of the port: the schedule math, the spec facade and
the data plane give exactly the reference's results (no tolerance: these
are plans, phases, hashes and numpy sample streams)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.api import ScheduleSpec as JScheduleSpec
from repro.data import DataPlane as JDataPlane
from repro.data import SyntheticImages as JSyntheticImages
from repro.data import bilinear_resize as jbilinear_resize
from repro.optim import staged_lr as jstaged_lr
from repro_torch import core
from repro_torch.api import ScheduleSpec
from repro_torch.data import DataPlane, SyntheticImages, bilinear_resize
from repro_torch.optim import staged_lr

torch.set_num_threads(1)

_BASE = dict(input_size=32, axis="resolution", batch_size=64,
             dataset_size=2048, n_workers=4, epochs=8, seed=3)

# (scheme, overrides): baseline / dbl / hybrid x both axes x a few n_small,
# k, sub_sizes and n_steps values, in SPMD-step and PS-sim-epoch modes
SPECS = [
    ("baseline", {}),
    ("baseline", {"n_steps": 12}),
    ("baseline", {"lr_stage_epochs": (4, 4), "lr_stage_lrs": (0.1, 0.01)}),
    ("dbl", {"n_small": 1}),
    ("dbl", {"n_small": 3, "k": 1.1}),
    ("dbl", {"n_small": 2, "k": 1.02, "n_steps": 10}),
    ("dbl", {"n_small": 4, "n_steps": 7, "factor": "sqrt"}),
    ("dbl", {"n_small": 3, "lr_stage_epochs": (5, 3),
             "lr_stage_lrs": (0.2, 0.02)}),
    ("hybrid", {"n_small": 3, "sub_sizes": (24, 32), "n_steps": 6,
                "stage_epochs": (2,), "stage_lrs": (0.05,)}),
    ("hybrid", {"n_small": 3, "k": 1.05, "sub_sizes": (24, 32),
                "batch_size": 512, "n_steps": 40, "stage_lrs": (0.05,)}),
    ("hybrid", {"n_small": 2, "sub_sizes": (16, 24, 32), "n_steps": 25}),
    ("hybrid", {"n_small": 1, "k": 1.1, "sub_sizes": (16, 32)}),
    ("hybrid", {"n_small": 0, "sub_sizes": (24, 32), "n_steps": 9}),
    ("hybrid", {"n_small": 3, "sub_sizes": (24, 32), "n_steps": 3,
                "sub_dropouts": (0.1, 0.2)}),
    ("hybrid", {"axis": "seq_len", "input_size": 128, "n_small": 2,
                "sub_sizes": (64, 96, 128), "n_steps": 30,
                "tm_a": 0.01, "tm_b": 0.3}),
    ("hybrid", {"axis": "seq_len", "input_size": 256, "n_small": 1,
                "sub_sizes": (128, 256), "epochs": 6}),
    ("dbl", {"axis": "seq_len", "input_size": 512, "n_small": 2,
             "n_steps": 5}),
]


def _kw(scheme, over):
    return dict(_BASE, scheme=scheme, **over)


def _phase_fields(p, n_epochs=12):
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    d["plan"] = None if p.plan is None else dataclasses.asdict(p.plan)
    d["layout"] = None if p.layout is None else dataclasses.asdict(p.layout)
    fn = d.pop("lr_for_epoch")
    d["lr_for_epoch"] = None if fn is None else [fn(e)
                                                 for e in range(n_epochs)]
    return d


@pytest.mark.parametrize("scheme,over", SPECS,
                         ids=[f"{s}-{i}" for i, (s, _) in enumerate(SPECS)])
def test_to_phases_equal_reference(scheme, over):
    jph = JScheduleSpec(**_kw(scheme, over)).to_phases()
    tph = ScheduleSpec(**_kw(scheme, over)).to_phases()
    assert len(tph) == len(jph) > 0
    for a, b in zip(tph, jph):
        assert _phase_fields(a) == _phase_fields(b)
        if b.layout is not None:
            assert np.array_equal(a.layout.weights().numpy(),
                                  np.asarray(b.layout.weights()))


@pytest.mark.parametrize("scheme,over", SPECS[::2],
                         ids=[f"{s}-{2 * i}"
                              for i, (s, _) in enumerate(SPECS[::2])])
def test_spec_json_plan_and_key_equal_reference(scheme, over):
    j = JScheduleSpec(**_kw(scheme, over))
    t = ScheduleSpec(**_kw(scheme, over))
    assert t.to_json() == j.to_json()
    assert t.run_key() == j.run_key()
    assert ScheduleSpec.from_json(j.to_json()) == t
    assert dataclasses.asdict(t.plan()) == dataclasses.asdict(j.plan())


@pytest.mark.parametrize("k", [1.0, 1.05, 1.2])
@pytest.mark.parametrize("factor", ["ds_over_dl", "sqrt", "none"])
def test_solve_plan_and_plan_table_equal_reference(k, factor):
    tm, jtm = core.LinearTimeModel(0.001, 0.0246), \
        jcore.LinearTimeModel(0.001, 0.0246)
    kw = dict(B_L=128, d=50_000, n_workers=4, k=k, factor=factor)
    t = [dataclasses.asdict(p) for p in core.plan_table(tm, **kw)]
    j = [dataclasses.asdict(p) for p in jcore.plan_table(jtm, **kw)]
    assert t == j
    for ns in range(5):
        assert dataclasses.asdict(core.solve_plan(tm, n_small=ns, **kw)) == \
            dataclasses.asdict(jcore.solve_plan(jtm, n_small=ns, **kw))


@pytest.mark.parametrize("axis,sizes", [("resolution", (16, 24, 32)),
                                        ("seq_len", (64, 128, 256))])
def test_cyclic_schedule_and_adapt_batch_equal_reference(axis, sizes):
    kw = dict(stages=(5, 3, 2), stage_lrs=(0.2, 0.02, 0.002),
              sub_sizes=sizes, sub_dropouts=(0.0, 0.1, 0.2), B_ref=96,
              axis=axis)
    assert [dataclasses.asdict(p) for p in core.cyclic_schedule(**kw)] == \
        [dataclasses.asdict(p) for p in jcore.cyclic_schedule(**kw)]
    for size in sizes:
        for f in (0.0, 0.3, 1.0):
            assert core.adapt_batch(96, max(sizes), size, axis=axis,
                                    mem_fixed_frac=f) == \
                jcore.adapt_batch(96, max(sizes), size, axis=axis,
                                  mem_fixed_frac=f)


def test_staged_lr_equal_reference():
    t, j = staged_lr([80, 40, 20], [0.2, 0.02, 0.002]), \
        jstaged_lr([80, 40, 20], [0.2, 0.02, 0.002])
    assert [t(e) for e in range(200)] == [j(e) for e in range(200)]


def test_synthetic_images_and_resize_equal_reference():
    kw = dict(n_train=64, n_test=16, num_classes=10, seed=5)
    t, j = SyntheticImages(**kw), JSyntheticImages(**kw)
    idx = np.array([0, 5, 63, 5, 17])
    for res in (32, 24, 20, 16):
        tb, jb = t.batch_at(idx, res), j.batch_at(idx, res)
        assert tb.keys() == jb.keys()
        for k in tb:
            assert tb[k].dtype == jb[k].dtype
            assert np.array_equal(tb[k], jb[k])
        for k in ("images", "labels"):
            assert np.array_equal(t.test_set(res)[k], j.test_set(res)[k])
    img = np.random.RandomState(0).rand(32, 32, 3).astype(np.float32)
    for out in (8, 24, 31, 32, 40):
        assert np.array_equal(bilinear_resize(img, out),
                              jbilinear_resize(img, out))


def test_data_plane_batches_equal_reference():
    spec = dict(_BASE, scheme="hybrid", n_small=3, sub_sizes=(24, 32),
                n_steps=6, batch_size=16, dataset_size=256,
                stage_epochs=(2,), stage_lrs=(0.05,))
    src = dict(n_train=256, n_test=8, num_classes=10, seed=0)
    tph = ScheduleSpec(**spec).to_phases()
    jph = JScheduleSpec(**spec).to_phases()
    with DataPlane(SyntheticImages(**src), seed=7) as tp:
        jp = JDataPlane(JSyntheticImages(**src), seed=7)
        tp.bind(tph)
        jp.bind(jph)
        g = 0
        for a, b in zip(tph, jph):
            for s in range(a.n_steps):
                assert np.array_equal(tp.global_indices(a, s),
                                      jp.global_indices(b, s))
                tb, jb = tp(a, g), jp(b, g)
                for k in jb:
                    assert np.array_equal(tb[k], jb[k])
                g += 1
            assert tp.batch_struct(a, stacked=3) == {
                k: (tuple(s.shape), np.dtype(s.dtype))
                for k, s in jp.batch_struct(b, stacked=3).items()}


def test_data_plane_scan_feed_cpu_chunks_equal_batches():
    spec = dict(_BASE, scheme="hybrid", n_small=3, sub_sizes=(24, 32),
                n_steps=7, batch_size=16, dataset_size=256)
    phases = ScheduleSpec(**spec).to_phases()
    with DataPlane(SyntheticImages(n_train=256, n_test=8), seed=1) as plane:
        plane.bind(phases)
        g = 0
        for ph in phases:
            chunks = list(plane.scan_feed(ph, g, ph.n_steps, 2, "cpu"))
            assert [c for c, _ in chunks] == \
                [min(2, ph.n_steps - i) for i in range(0, ph.n_steps, 2)]
            stacked = {k: torch.cat([b[k] for _, b in chunks])
                       for k in chunks[0][1]}
            for j in range(ph.n_steps):
                ref = plane(ph, g + j)
                for k in ref:
                    assert np.array_equal(stacked[k][j].numpy(), ref[k])
            g += ph.n_steps
    assert plane._pool is None          # close() joined the prefetch thread


def test_data_plane_prefetch_thread_ends_at_interpreter_exit():
    """A plane left open with a chunk still staging must not hold the
    interpreter at exit (the reference leaves its executor open)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = (
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.api import ScheduleSpec\n"
        "from repro_torch.data import DataPlane, SyntheticImages\n"
        "ph = ScheduleSpec(scheme='hybrid', input_size=32, n_small=3,\n"
        "                  sub_sizes=(24, 32), n_steps=40, batch_size=64,\n"
        "                  dataset_size=256).to_phases()\n"
        "plane = DataPlane(SyntheticImages(n_train=256, n_test=8))\n"
        "plane.bind(ph)\n"
        "feed = plane.scan_feed(ph[0], 0, ph[0].n_steps, 4, 'cpu')\n"
        "next(feed)\n"
        "assert plane._pool is not None\n"
        "print('left open')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "left open"
