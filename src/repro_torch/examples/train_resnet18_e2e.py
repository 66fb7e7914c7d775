"""End-to-end example (paper-faithful), the port of the reference's
``examples/train_resnet18_e2e.py``: ResNet-18 (full width, ~11M params)
trained with baseline / dual-batch / hybrid schemes — each scheme is ONE
declarative ``ScheduleSpec`` (they differ only in the fields a ``replace``
touches) executed by ``repro_torch.api.run`` on the parameter-server
simulator with synthetic CIFAR-like data, reporting accuracy AND simulated
wall-clock (the paper's two evaluation axes).  The runs take the traced
replay (one B3 launch per simulated event on the card), which replays the
event path's timeline and samples exactly.

  PYTHONPATH=src python -m repro_torch.examples.train_resnet18_e2e [--quick]

``--device cpu`` runs it on the CPU (slowly); the default is the card.
"""
import argparse
from dataclasses import replace

import torch

from repro_torch import models
from repro_torch.api import RunConfig, ScheduleSpec
from repro_torch.api import run as api_run
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.data import SyntheticImages
from repro_torch.device import resolve_device


def make_fns_factory(cfg, data, device):
    """``fns_factory(resolution) -> (grad_fn, None, eval_fn)`` for the PS
    simulator: the gradient of the model's loss, and the loss and accuracy
    on ``data``'s test set at that resolution (on ``device``).  Batches
    come from the DataPlane, so the data_fn slot is None."""
    def fns_factory(resolution):
        def grad_fn(p, batch):
            # the leaves may be views of the flat store: differentiate
            # detached copies of them
            leaves, treedef = tree_flatten(p)
            xs = [leaf.detach().requires_grad_() for leaf in leaves]
            loss, _ = models.loss_fn(tree_unflatten(treedef, xs), cfg, batch)
            return tree_unflatten(treedef,
                                  list(torch.autograd.grad(loss, xs)))

        test = {k: torch.from_numpy(v).to(device)
                for k, v in data.test_set(resolution).items()}

        def eval_fn(p):
            with torch.no_grad():
                loss, m = models.loss_fn(p, cfg, test)
            return {"test_loss": round(float(loss), 3),
                    "test_acc": round(float(m["accuracy"]), 3)}
        return grad_fn, None, eval_fn
    return fns_factory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="slim model + fewer epochs")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    width = 16 if args.quick else 64        # 64 = real ResNet-18 (11M)
    epochs = 8 if args.quick else 16
    ncls = 32
    cfg = replace(get_config("cifar-resnet18"), d_model=width,
                  vocab_size=ncls)
    data = SyntheticImages(n_train=2048, n_test=512, num_classes=ncls,
                           noise=1.0, seed=0)

    def init():
        return models.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=device)
    n_params = sum(t.numel() for t in tree_leaves(init()))
    print(f"ResNet-18 width {width}: {n_params/1e6:.1f}M params on {device}")
    fns_factory = make_fns_factory(cfg, data, device)

    # One base spec; the three schemes are field-level deltas on it.  The
    # paper's two LR stages (lr, lr/5-ish) live in the spec: flat schemes
    # as a staged-LR schedule, hybrid as per-LR-stage CPL ladders 24 -> 32.
    base = ScheduleSpec(
        scheme="baseline", input_size=32, axis="resolution", batch_size=64,
        dataset_size=2048, n_workers=4, n_small=3, k=1.05, epochs=epochs,
        lr=0.05, lr_stage_epochs=(epochs * 3 // 4, epochs),
        lr_stage_lrs=(0.05, 0.01), tm_a=0.001, tm_b=0.0246, sync="bsp",
        seed=0)
    specs = {
        "baseline": base,                   # all-large BSP (n_small forced 0)
        "dual-batch": base.replace(scheme="dbl", sync="asp"),
        "hybrid": base.replace(scheme="hybrid", sync="asp",
                               lr_stage_epochs=(), lr_stage_lrs=(),
                               sub_sizes=(24, 32), sub_dropouts=(0.0, 0.0),
                               stage_epochs=(epochs // 2, epochs // 2),
                               stage_lrs=(0.05, 0.01)),
    }

    results = {}
    for name, spec in specs.items():
        # data= -> the run builds its DataPlane seeded from spec.seed, so
        # the spec alone pins the per-(phase, worker, step) sample streams
        res = api_run(spec, RunConfig(traced=True), init_params=init(),
                      fns_factory=fns_factory, data=data, device=device)
        last = res.last
        if spec.scheme == "hybrid":
            # final full-resolution eval (the ladder ends at 32 but the
            # last epoch record may predate the merge)
            _, _, eval_fn = fns_factory(spec.input_size)
            last = {**last, **eval_fn(res.params)}
            print(f"hybrid history: {len(res.history)} epoch records over "
                  f"{len(res.phases)} phases (absolute sim-time offsets)")
        results[name] = (last, res.time)

    print(f"\n{'scheme':<12} {'test_acc':>8} {'test_loss':>9} "
          f"{'sim_time_s':>10}")
    base_t = results["baseline"][1]
    for name, (h, t) in results.items():
        print(f"{name:<12} {h['test_acc']:>8.3f} {h['test_loss']:>9.3f} "
              f"{t:>10.2f}  ({(1 - t / base_t) * 100:+.1f}% time vs baseline)")


if __name__ == "__main__":
    main()
