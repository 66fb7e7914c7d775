"""Quickstart on the port: solve a dual-batch plan (paper Eq. 4-8),
declare the same settings as ONE serializable ``ScheduleSpec``, map the
plan onto the synchronous layout, and run a short dual-batch training on
a reduced LM config (the five steps of the reference's
``examples/quickstart.py``).

  python -m repro_torch.examples.quickstart                # on the card
  python -m repro_torch.examples.quickstart --device cpu   # on the CPU
"""
import argparse

from repro_torch.api import ScheduleSpec
from repro_torch.core import LinearTimeModel, layout_from_plan, plan_table
from repro_torch.launch.train import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where step 5 trains (default: the card)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)

    # 1) The Eq. 2 time model t_batch(x) = a*x + b, here the paper's
    #    GTX1080/TensorFlow ratio b/a = 24.57 (Table 2).
    tm = LinearTimeModel(a=1.0, b=24.57)

    # 2) The dual-batch plan: 4 workers, B_L = 500, CIFAR-100 sized data.
    print("paper Table 2 (k=1.05):")
    for plan in plan_table(tm, B_L=500, d=50_000, n_workers=4, k=1.05):
        print(f"  n_S={plan.n_small}: B_S={plan.B_S:4d}  d_S={plan.d_S:8.0f}"
              f"  d_L={plan.d_L:8.0f}  factor={plan.update_factor_small:.3f}")

    # 3) The same settings as ONE declarative spec; it serializes
    #    canonically, so its hash names the run's artifacts.
    spec = ScheduleSpec(scheme="dbl", input_size=32, batch_size=500,
                        dataset_size=50_000, n_workers=4, n_small=3, k=1.05,
                        tm_a=1.0, tm_b=24.57)
    plan = spec.plan()
    assert ScheduleSpec.from_json(spec.to_json()) == spec
    print(f"\nspec.plan(): n_S={plan.n_small}  B_S={plan.B_S}  "
          f"factor={plan.update_factor_small:.3f}  "
          f"(run_key {spec.run_key()} from canonical JSON)")

    # 4) The plan drives the synchronous layout.
    layout = layout_from_plan(plan, global_batch=32)
    print(f"synchronous layout: {layout.n_workers} worker-rows x "
          f"{layout.per_worker} examples, small group keeps "
          f"{layout.small_valid}/{layout.per_worker} rows at factor "
          f"{layout.factor_small:.3f}")
    print("per-example weights:", layout.weights())

    # 5) A short dual-batch training run on reduced phi3-mini: the CLI
    #    builds a ScheduleSpec from its flags and hands it to api.run.
    print("\nshort dual-batch training (reduced phi3):")
    cli = ["--arch", "phi3-mini-3.8b", "--steps", str(args.steps),
           "--scheme", "dbl", "--seq", "32", "--global-batch", "16",
           "--lr", "5e-3"]
    if args.device is not None:
        cli += ["--device", args.device]
    return run(cli)


if __name__ == "__main__":
    main()
