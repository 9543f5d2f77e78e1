"""Quickstart on the PyTorch port: DFL-DDS in ~40 lines (the counterpart of
``quickstart.py``).

Ten vehicles drive a grid road network; each holds a non-IID shard of
(synthetic) MNIST; every global epoch they exchange models with whoever is
in radio range, choose aggregation weights by minimizing the KL divergence
of their state vectors (the paper's P1), and take local SGD steps. The
gossip mix goes through the hand-written CUDA kernels on a card (their plain
versions on the CPU).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --smoke --device cpu

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig, run_simulation  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings so the run finishes in seconds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = SimulationConfig(
        algorithm="dds",          # the paper's algorithm ("dfl" / "sp" = baselines)
        road_net="grid",
        num_vehicles=6 if args.smoke else 10,
        epochs=4 if args.smoke else 30,
        local_steps=2 if args.smoke else 4,  # E
        batch_size=16 if args.smoke else 32,  # B
        lr=0.15,
        eval_every=2 if args.smoke else 10,
        eval_samples=200 if args.smoke else 500,
        p1_steps=30 if args.smoke else 80,  # EG iterations for the convex problem P1
        seed=0,
        device=str(resolve_device(args.device)),
    )

    n = (1_500, 300) if args.smoke else (6_000, 1_000)
    dataset = synthetic_mnist(n_train=n[0], n_test=n[1])
    result = run_simulation(cfg, dataset=dataset, progress=True)

    print("\nepoch history:", result.epochs_evaluated)
    print("avg accuracy :", [round(a, 3) for a in result.avg_accuracy])
    print("state-vector entropy (diversity) first->last: "
          f"{result.entropy[0].mean():.3f} -> {result.entropy[-1].mean():.3f} bits")
    print(f"V2V traffic: {result.total_comm_mb():.2f} MB over {cfg.epochs} epochs")
    print(f"quickstart OK: final average accuracy over {cfg.num_vehicles} "
          f"vehicles = {result.final_accuracy():.3f} on {cfg.device}")
    return result.final_accuracy()


if __name__ == "__main__":
    main()
