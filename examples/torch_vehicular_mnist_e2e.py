"""End-to-end run on the PyTorch port: the paper's experiment, start to
finish (the counterpart of ``vehicular_mnist_e2e.py``).

Trains the paper's 21,840-parameter MNIST CNN with DFL-DDS across a 24-vehicle
federation on a grid road network for 150 global epochs (600 local steps per
vehicle), evaluating per-vehicle accuracy, diversity (entropy / KL), and
consensus distance along the way — then prints the paper's headline
comparison against the DFL and SP baselines. ``--smoke`` runs the three
algorithms at a tiny size and prints the same summary and claims.

  PYTHONPATH=src python examples/torch_vehicular_mnist_e2e.py [--epochs 150]
  PYTHONPATH=src python examples/torch_vehicular_mnist_e2e.py --smoke --device cpu

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.fed import metrics  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig, run_simulation  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--vehicles", type=int, default=24)
    ap.add_argument("--road-net", default="grid")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings so the run finishes in seconds")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    if args.smoke:
        args.epochs, args.vehicles = 4, 6

    n = (1_500, 300) if args.smoke else (24_000, 2_000)
    ds = synthetic_mnist(n_train=n[0], n_test=n[1])
    results = {}
    for algo in ("dds", "dfl", "sp"):
        print(f"=== {algo.upper()} ===")
        cfg = SimulationConfig(
            algorithm=algo, road_net=args.road_net,
            num_vehicles=args.vehicles, epochs=args.epochs,
            local_steps=2 if args.smoke else 4, batch_size=16 if args.smoke else 32,
            lr=0.15, eval_every=max(args.epochs // 10, 1),
            eval_samples=200 if args.smoke else 1_000,
            p1_steps=30 if args.smoke else 80, seed=0, device=device)
        results[algo] = run_simulation(cfg, dataset=ds, progress=True)

    print("\n================= summary =================")
    print(f"{'algorithm':12s} {'final avg acc':>14s} {'min vehicle':>12s} "
          f"{'entropy':>9s} {'consensus':>10s}")
    for algo, res in results.items():
        accs = res.vehicle_accuracy[-1]
        print(f"{algo:12s} {res.final_accuracy():14.4f} {accs.min():12.4f} "
              f"{res.entropy[-1].mean():9.3f} {res.consensus_distance[-1]:10.5f}")

    dds, dfl, sp = (results[a] for a in ("dds", "dfl", "sp"))
    print("\npaper claims on this run:")
    print(f"  DFL-DDS >= DFL   (avg acc): {dds.final_accuracy() >= dfl.final_accuracy() - 0.02}")
    print(f"  DFL-DDS >= SP    (avg acc): {dds.final_accuracy() >= sp.final_accuracy() - 0.02}")
    corr = metrics.pearson(sp.vehicle_accuracy[-1], sp.entropy[-1])
    print(f"  accuracy-diversity Pearson (SP): {corr:.3f} (paper: strongly positive)")
    cd = np.mean(dds.consensus_distance) <= np.mean(dfl.consensus_distance) * 1.1
    print(f"  DDS consensus distance <= DFL: {cd}")
    print(f"vehicular_mnist_e2e OK: dds / dfl / sp, {args.vehicles} vehicles x "
          f"{args.epochs} epochs on {device}")
    return results


if __name__ == "__main__":
    main()
