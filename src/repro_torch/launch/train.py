"""Training entry point.

Counterpart of ``repro.launch.train``. Two modes:
  * --arch mnist-cnn|cifar-cnn : the paper's experiments — federated CNN
    training over a vehicular network (delegates to
    ``repro_torch.fed.simulator``); with ``--checkpoint-dir`` the accuracy
    history is checkpointed (``repro_torch.checkpoint``, the reference's
    ``.npz`` layout) after the run.
  * --arch <transformer id>    : DFL-DDS over language models
    (``launch.steps.build_dds_train_step``): ``--vehicles`` copies of one
    random model on a ring contact graph, each step a round on fresh random
    tokens (and, for a VLM / audio config, frontend prefix embeddings) drawn
    from a ``torch.Generator`` seeded by ``--seed``; one ``loss`` / ``kl`` line
    per step (the port-only ``moonlight-16b-a3b`` too). ``--reduced`` gives
    the 2-layer variant for the CPU; with
    ``--checkpoint-dir`` the stacked parameters are checkpointed after the
    run in the reference's ``.npz`` layout.

``--device`` defaults to ``cuda`` and raises without a CUDA device; it never
falls back to the CPU. ``--execution auto`` lets the cost model pick the
backend, contact format, mixing backend and slot budget
(``roofline.scenario_cost``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist-cnn --algorithm dds --epochs 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch mnist-cnn --device cpu \\
      --vehicles 6 --epochs 2 --eval-every 1 --checkpoint-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
      --device cpu --vehicles 4 --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import checkpoint as ckpt_lib
from ..configs.registry import ARCHITECTURES, PAPER_MODELS, PORT_ONLY, get_config
from ..fed.simulator import SimulationConfig, run_simulation
from . import steps as steps_lib
from .serve import resolve_device


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


def ring_contact(num_vehicles: int, device=None) -> torch.Tensor:
    """The ``[V, V]`` 0/1 contact matrix of vehicles meeting around a loop
    road: each meets itself and its two neighbours."""
    contact = torch.eye(num_vehicles, dtype=torch.float32)
    for i in range(num_vehicles):
        contact[i, (i + 1) % num_vehicles] = contact[i, (i - 1) % num_vehicles] = 1.0
    return contact.to(device)


def run_transformer_federation(args):
    """``args.steps`` DDS rounds of ``args.vehicles`` copies of ``args.arch``.
    Returns the final (params, opt_state, state_matrix) and the per-step
    metrics: loss, kl and the step's host seconds (floats)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    v, b, s = args.vehicles, args.per_vehicle_batch, args.seq_len
    ts = steps_lib.build_dds_train_step(cfg, lr=args.lr, remat=False,
                                        p1_steps=args.p1_steps)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt_state, state_matrix = steps_lib.init_train_state(cfg, v, gen, device=device)
    target = torch.full((v,), 1.0 / v, device=device)
    contact = ring_contact(v, device)

    history = []
    for it in range(args.steps):
        tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen, device=device)
        prefix = None
        if cfg.embed_input:
            prefix = 0.02 * torch.randn((v, b, cfg.frontend_tokens, cfg.d_model),
                                        generator=gen, device=device)
        t0 = time.perf_counter()
        params, opt_state, state_matrix, metrics = ts.fn(
            params, opt_state, state_matrix, tokens, contact, target, prefix)
        m = {name: float(x) for name, x in metrics.items()}     # waits for the round
        m["seconds"] = time.perf_counter() - t0
        history.append(m)
        print(f"step {it:3d} loss={m['loss']:.4f} kl={m['kl']:.4f} "
              f"({m['seconds']:.2f}s)", flush=True)

    if args.checkpoint_dir:
        mgr = ckpt_lib.CheckpointManager(args.checkpoint_dir)
        mgr.save(args.steps, params, {"arch": cfg.name})
        print("params checkpointed to", args.checkpoint_dir)
    return params, opt_state, state_matrix, history


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(ARCHITECTURES) + sorted(PORT_ONLY) + sorted(PAPER_MODELS))
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
