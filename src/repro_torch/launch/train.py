"""End-to-end training CLI — thin front end over ``repro_torch.api``
(the port of the reference's ``launch/train.py``: the same flags, the
same schedules and the same JSON step records).

Runs the paper's three schemes on synthetic LM data:
  --scheme baseline   single (large) batch size
  --scheme dbl        dual-batch learning (weighted step)
  --scheme hybrid     dual-batch x cyclic progressive (seq-len scheduled)

Each scheme is ONE declarative ``repro_torch.api.ScheduleSpec``
(``build_spec``) run by ``repro_torch.api.run`` on the synchronous engine.

With ``--optimizer sgd`` the dual-batch parameter update takes the fused
server-update path (paper §3.4): one backward of the merged loss and one
``dbl_apply_flat2d`` (B1) launch per step over the flat store
(``--no-scan-loop``: the two group gradients and one ``dbl_merge_flat2d``
(B2) launch; ``--no-fused-merge``: the plain per-leaf update).

The model is drawn from a ``torch.Generator`` on the device, seeded by
``--seed``; ``--reduced`` (the default) shrinks the config, ``--full``
keeps its published widths.  Everything runs on the card; ``--device
cpu`` is the only way onto the CPU.

Usage:
  python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --steps 200 --scheme hybrid
  python -m repro_torch.launch.train --arch phi3-mini-3.8b --full \\
      --optimizer sgd --scheme hybrid --seq 128 --global-batch 16
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import models
from repro_torch.api import RunConfig, ScheduleSpec
from repro_torch.api import run as api_run
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data import DataPlane, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.engine import TrainEngine
from repro_torch.optim import make_optimizer


def build_spec(args) -> ScheduleSpec:
    """The CLI's scheme as ONE declarative ``ScheduleSpec``.  The time
    model is shape-relative (a=1, b=24.6): only its ratios reach the
    dual-batch solver."""
    spec = ScheduleSpec(
        scheme=args.scheme, input_size=args.seq, axis="seq_len",
        batch_size=args.global_batch, dataset_size=args.global_batch * 64,
        n_workers=4, n_small=args.n_small, k=args.k, n_steps=args.steps,
        lr=args.lr, micro_steps=args.micro_steps, tm_a=1.0, tm_b=24.6,
        seed=args.seed)
    if args.scheme == "hybrid":
        # CPL sub-stages low -> high seq (the paper's 2-sub-stage split),
        # the dual-batch plan re-solved per sub-stage
        sub_sizes = (max(16, args.seq // 2), args.seq)
        spec = spec.replace(sub_sizes=sub_sizes,
                            sub_dropouts=(0.0,) * len(sub_sizes),
                            stage_epochs=(len(sub_sizes),),
                            stage_lrs=(args.lr,))
    return spec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS),
                    default="phi3-mini-3.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--scheme", choices=("baseline", "dbl", "hybrid"),
                    default="hybrid")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--k", type=float, default=1.05)
    ap.add_argument("--n-small", type=int, default=3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--micro-steps", type=int, default=0,
                    help="micro-update mode: small-group local SGD steps "
                         "per global step")
    ap.add_argument("--no-fused-merge", dest="fused", action="store_false",
                    default=True,
                    help="unfused server update (dual-batch SGD path)")
    ap.add_argument("--no-scan-loop", dest="scan", action="store_false",
                    default=True,
                    help="step-at-a-time loop (one dbl_merge_flat2d launch a "
                         "step) instead of the flat-store chunk loop")
    ap.add_argument("--server-momentum", type=float, default=0.0,
                    help="PS-server momentum folded into the fused kernel "
                         "pass (dual-batch SGD chunk path)")
    ap.add_argument("--no-overlap-compile", dest="overlap",
                    action="store_false", default=True,
                    help="accepted for the reference's CLI; eager PyTorch "
                         "compiles nothing ahead")
    ap.add_argument("--no-prefetch", dest="prefetch", action="store_false",
                    default=True,
                    help="stage chunks synchronously instead of "
                         "double-buffering them on a background thread")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir; saves at every phase boundary")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest phase-boundary checkpoint "
                         "in --ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap


def run(argv=None):
    """Parse ``argv``, train, print one JSON record per logged step, and
    return the records."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt:
        ap.error("--resume requires --ckpt (the directory to resume from)")
    # plain-SGD dual-batch -> the paper §3.4 server update.  That update
    # has no momentum/weight-decay state, so the optimizer is built to
    # match; stateful optimizers (adamw) keep the weighted-mean path.
    sgd_server = (args.optimizer == "sgd"
                  and args.scheme in ("dbl", "hybrid")
                  and args.micro_steps == 0)
    if args.server_momentum and not sgd_server:
        ap.error("--server-momentum needs the dual-batch SGD server path "
                 "(--optimizer sgd, --scheme dbl/hybrid, no --micro-steps)")
    if args.server_momentum and not (args.scan and args.fused):
        ap.error("--server-momentum needs the fused scan loop "
                 "(drop --no-scan-loop / --no-fused-merge)")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    data = SyntheticTokens(vocab=min(cfg.vocab_size, 256), seed=args.seed,
                           n_examples=max(4096, args.global_batch * 64))
    params = models.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)

    spec = build_spec(args)
    phases = spec.to_phases()
    if sgd_server:
        opt = make_optimizer("sgd", momentum=0.0, weight_decay=0.0)
        mom = (f"server momentum {args.server_momentum} in-kernel"
               if args.server_momentum else "no momentum")
        print("# dual-batch SGD: paper §3.4 server update "
              f"({'fused dbl_merge' if args.fused else 'unfused'} path, "
              f"{mom}, no weight decay)")
    else:
        opt = make_optimizer(args.optimizer, weight_decay=0.01)
    opt_state = opt.init(params)
    engine = TrainEngine(cfg, opt, sgd_server=sgd_server,
                         fused_merge=("auto" if args.fused else False),
                         scan_loop=("auto" if args.scan else False),
                         server_momentum=(args.server_momentum
                                          if sgd_server else 0.0),
                         overlap_compile=args.overlap, device=device)
    # counter-keyed per-(phase, worker, step) streams, stateless in the
    # global step, so a phase-boundary resume replays the uninterrupted
    # run's stream exactly
    plane = DataPlane(data, seed=spec.seed, prefetch=args.prefetch)

    def log_fn(rec):
        print(json.dumps(_to_cli_rec(rec)), flush=True)

    try:
        res = api_run(spec,
                      RunConfig(backend="spmd", prefetch=args.prefetch,
                                ckpt_dir=args.ckpt or None,
                                resume=args.resume, log_fn=log_fn),
                      init_params=params, opt_state=opt_state,
                      engine=engine, plane=plane)
    finally:
        plane.close()
    history = [_to_cli_rec(r) for r in res.history]
    if res.resumed_from is not None:
        print(f"# resumed from phase boundary {res.resumed_from}")
    if args.ckpt:
        print(f"saved {len(phases) - (res.resumed_from or 0)} phase-boundary "
              f"checkpoint(s) -> {args.ckpt}")
    return history


def _to_cli_rec(rec: dict) -> dict:
    return {"step": rec["step"], "seq": rec["size"], "batch": rec["batch"],
            "loss": rec["loss"], "tokens": rec["tokens"],
            "wall_s": rec["wall_s"]}


if __name__ == "__main__":
    run()
