"""``chip_smoke.py`` phase 5 on the CPU: why its card-vs-CPU parity runs
the CPU port on the card run's side of every ReLU kink, and that it still
tells a fault from rounding.

Phase 5 trains the width-8 ResNet-18 schedule (hybrid, 24 px x 3 steps
then 32 px x 3, lr 0.005) on the card and on the CPU and holds the two
within ``PARITY_BAND``.  Here both runs are the CPU port: the first (the
card's stand-in) starts from params carrying 2e-7 relative noise (about
2 ulp, the size of two devices' rounding differences) or carries a
planted fault; the second starts from the clean params.

* Free-running, some draws end outside the band: a ReLU input within
  rounding of 0 falls on either side, the step's gradient jumps there,
  and the later steps carry the difference on (ROADMAP C4).
* With the second run taking every unit to the side the first took
  (``ReluSides``), every draw stays inside the band.
* Two planted faults still land outside it: an lr 1 % off, and the
  convolutions' inputs rounded to TF32's 10 mantissa bits (what cuDNN's
  TF32 mode does to them).

As a script it prints the sweep:
``PYTHONPATH=src python tests/test_torch_parity_kinks.py [draws]``.
"""
import contextlib
import functools
import importlib.util
import pathlib
import sys
from dataclasses import replace
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from repro_torch import api, models
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import SyntheticImages
from repro_torch.engine import TrainEngine
from repro_torch.kernels import dbl_merge as K
from repro_torch.models import resnet
from repro_torch.optim import sgd_momentum

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()
M = SimpleNamespace(api=api, models=models, TrainEngine=TrainEngine,
                    sgd_momentum=sgd_momentum, K=K, tree_leaves=tree_leaves)
SMALL = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
SOURCE = SyntheticImages(**CS.PARITY_SOURCE)
P0 = models.init_params(SMALL, torch.Generator().manual_seed(0),
                        device="cpu")
NOISE = 2e-7
DRAWS = 24


def _spec(lr_scale=1.0, **kw):
    kw = dict(CS.PARITY_SPEC, **kw)
    kw["stage_lrs"] = tuple(lr * lr_scale for lr in kw["stage_lrs"])
    return CS._spec(api, **kw)


def _noisy(draw):
    gen = torch.Generator().manual_seed(100 + draw)
    return tree_map(lambda t: t * (1 + NOISE * torch.randn(
        t.shape, generator=gen)), P0)


def _run(params, spec=None):
    return CS.drive(M, spec or _spec(), SMALL, device="cpu", source=SOURCE,
                    params=tree_map(lambda t: t.clone(), params))


def _gaps(a, b):
    """(largest loss gap, largest param gap), as phase 5 reads them."""
    return (max(abs(x - y) for x, y in zip(a["losses"], b["losses"])),
            max(float((x - y).abs().max()) for x, y in
                zip(tree_leaves(a["res"].params),
                    tree_leaves(b["res"].params))))


def _inside(gaps):
    return gaps[0] <= CS.PARITY_BAND["loss"] and \
        gaps[1] <= CS.PARITY_BAND["params"]


def _tf32(x):
    """x rounded to the nearest value with 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)


@contextlib.contextmanager
def _tf32_convs():
    """``F.conv2d`` on inputs and weights rounded to TF32 (the gradient
    passes through the rounding unchanged)."""
    conv2d = F.conv2d

    def rounded(x, w, *a, **kw):
        x = x + (_tf32(x.detach()) - x.detach())
        w = w + (_tf32(w.detach()) - w.detach())
        return conv2d(x, w, *a, **kw)
    F.conv2d = rounded
    try:
        yield
    finally:
        F.conv2d = conv2d


def _pair(params, spec=None, tf32=False):
    """A run from ``params`` with its kink sides recorded, and the clean
    run replayed on those sides: (recorded, replayed, ReluSides)."""
    sides = CS.ReluSides()
    with _tf32_convs() if tf32 else contextlib.nullcontext():
        rec = sides.record(resnet, lambda: _run(params, spec))
    rep = sides.replay(resnet, lambda: _run(P0))
    return rec, rep, sides


@functools.lru_cache(maxsize=None)
def _sweep(draws):
    clean = _run(P0)
    out = []
    for d in range(draws):
        rec, rep, sides = _pair(_noisy(d))
        out.append({"free": _gaps(rec, clean), "matched": _gaps(rec, rep),
                    "other_side": sides.other_side})
    return out


def test_free_runs_leave_the_band():
    sweep = _sweep(DRAWS)
    outside = [s for s in sweep if not _inside(s["free"])]
    assert outside, "no draw crossed a kink: the sweep shows nothing"
    # each draw that left the band had a unit on the other side
    assert all(s["other_side"] > 0 for s in outside)


def test_kink_matched_runs_hold_the_band():
    for s in _sweep(DRAWS):
        assert _inside(s["matched"]), s


@pytest.mark.parametrize("fault", ["lr_off_1pct", "tf32_inputs"])
def test_kink_matched_band_rejects_planted_faults(fault):
    spec = _spec(1.01) if fault == "lr_off_1pct" else None
    rec, rep, _ = _pair(P0, spec, tf32=fault == "tf32_inputs")
    assert not _inside(_gaps(rec, rep))


def test_relu_sides_refuse_a_run_that_differs():
    sides = CS.ReluSides()
    sides.record(resnet, lambda: _run(P0))
    with pytest.raises(AssertionError, match="ReLU"):
        sides.replay(resnet, lambda: _run(P0, _spec(n_steps=4)))
    assert resnet.F is F


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    sweep = _sweep(n)
    for key in ("free", "matched"):
        print(f"{key}: {n} draws of {NOISE:g} noise, largest loss gap "
              f"{max(s[key][0] for s in sweep):.3g}, largest param gap "
              f"{max(s[key][1] for s in sweep):.3g}, outside the band "
              f"{sum(not _inside(s[key]) for s in sweep)}")
    clean = _run(P0)
    for fault in ("lr_off_1pct", "tf32_inputs"):
        spec = _spec(1.01) if fault == "lr_off_1pct" else None
        rec, rep, _ = _pair(P0, spec, tf32=fault == "tf32_inputs")
        print(f"{fault}: free loss / param gap {_gaps(rec, clean)}, "
              f"kink-matched {_gaps(rec, rep)}")
