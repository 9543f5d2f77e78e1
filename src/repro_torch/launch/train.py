"""Training entry point.

Counterpart of ``repro.launch.train``. Two modes:
  * --arch mnist-cnn|cifar-cnn : the paper's experiments — federated CNN
    training over a vehicular network (delegates to
    ``repro_torch.fed.simulator``); with ``--checkpoint-dir`` the accuracy
    history is checkpointed (``repro_torch.checkpoint``, the reference's
    ``.npz`` layout) after the run.
  * --arch <transformer id>    : DFL-DDS over language models. Not ported
    yet: it needs ``launch/steps.py`` (the train step), and raises
    ``NotImplementedError`` naming it.

``--device`` defaults to ``cuda`` and raises without a CUDA device; it never
falls back to the CPU. ``--execution auto`` lets the cost model pick the
backend, contact format, mixing backend and slot budget
(``roofline.scenario_cost``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist-cnn --algorithm dds --epochs 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist-cnn --device cpu \\
      --vehicles 6 --epochs 2 --eval-every 1 --checkpoint-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse

import torch

from .. import checkpoint as ckpt_lib
from ..configs.registry import ARCHITECTURES, PAPER_MODELS
from ..fed.simulator import SimulationConfig, run_simulation


def run_cnn_federation(args):
    cfg = SimulationConfig(
        algorithm=args.algorithm,
        dataset="mnist" if "mnist" in args.arch else "cifar10",
        road_net=args.road_net,
        distribution=args.distribution,
        num_vehicles=args.vehicles,
        epochs=args.epochs,
        local_steps=args.local_steps,
        batch_size=args.batch_size,
        eval_every=args.eval_every,
        seed=args.seed,
        execution=args.execution,
        device=args.device,
    )
    res = run_simulation(cfg, progress=True)
    print(f"final avg accuracy: {res.final_accuracy():.4f}  "
          f"({res.wall_time:.1f}s, {cfg.epochs} epochs)")
    if res.execution_plan is not None:
        print(f"execution plan: {res.execution_plan['resolved']}")
    if args.checkpoint_dir:
        mgr = ckpt_lib.CheckpointManager(args.checkpoint_dir)
        meta = {"algorithm": cfg.algorithm}
        if res.execution_plan is not None:
            meta["execution_plan"] = res.execution_plan
        mgr.save(cfg.epochs, {"avg_accuracy": torch.tensor(res.avg_accuracy,
                                                           dtype=torch.float64)},
                 meta)
        print("history checkpointed to", args.checkpoint_dir)
    return res


def run_transformer_federation(args):
    raise NotImplementedError(
        f"--arch {args.arch}: DFL-DDS over a transformer needs launch/steps.py "
        "(the DDS train step, lm_loss, adamw), which repro_torch has not ported "
        "yet; the paper's CNNs (--arch mnist-cnn|cifar-cnn) train")


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(ARCHITECTURES) + sorted(PAPER_MODELS))
    ap.add_argument("--algorithm", default="dds", choices=["dds", "dfl", "sp"])
    ap.add_argument("--road-net", default="grid", choices=["grid", "random", "spider"])
    ap.add_argument("--distribution", default="balanced_noniid",
                    choices=["balanced_noniid", "unbalanced_iid"])
    ap.add_argument("--vehicles", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=80)
    ap.add_argument("--per-vehicle-batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--p1-steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--execution", default="manual", choices=["manual", "auto"],
                    help="auto picks backend/contact_format/mixing_backend/d_max "
                         "from the analytical cost model (roofline.scenario_cost)")
    ap.add_argument("--device", default="cuda",
                    help="where the run lives: cuda (the default; raises "
                         "without a CUDA device) or cpu")
    args = ap.parse_args(argv)

    if args.arch in PAPER_MODELS:
        args.vehicles = args.vehicles or 100
        return run_cnn_federation(args)
    args.vehicles = args.vehicles or 4
    return run_transformer_federation(args)


if __name__ == "__main__":
    main()
