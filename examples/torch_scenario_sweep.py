"""Scenario sweep on the PyTorch port: a miniature Fig. 8/9-style grid in one
call (the counterpart of ``scenario_sweep.py``).

The sweep runner walks the scenario axes (here road_net x algorithm) and
runs the seeds of each scenario together, on one stacked seed axis: three
seeds of DDS advance through one run, one gossip-mix launch per round for
all of them, not three serial runs. The beyond-paper 'highway' corridor net
and the 'd_fedavg' baseline are sweepable by name exactly like the paper's
scenarios. See also: python -m repro_torch.launch.sweep --help.

  PYTHONPATH=src python examples/torch_scenario_sweep.py
  PYTHONPATH=src python examples/torch_scenario_sweep.py --smoke --device cpu

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.data.synthetic import synthetic_mnist  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402
from repro_torch.launch.sweep import SweepSpec, run_sweep, summary_rows  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings so the run finishes in seconds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = SimulationConfig(
        num_vehicles=6 if args.smoke else 8,
        epochs=4 if args.smoke else 20,
        local_steps=2 if args.smoke else 4,
        batch_size=16 if args.smoke else 32,
        lr=0.15,
        eval_every=2 if args.smoke else 10,
        eval_samples=200 if args.smoke else 400,
        p1_steps=30 if args.smoke else 60,
        device=str(resolve_device(args.device)),
    )

    spec = SweepSpec(
        road_nets=("grid", "highway"),     # 'highway' is a beyond-paper registry entry
        algorithms=("dds", "d_fedavg"),    # so is train-then-aggregate 'd_fedavg'
        seeds=(0, 1, 2),
        base=base,
    )

    n = (1_500, 300) if args.smoke else (4_000, 800)
    results = run_sweep(spec, dataset=synthetic_mnist(n_train=n[0], n_test=n[1]))

    print()
    print("\n".join(summary_rows(results)))
    print()
    for sr in results:
        epochs, curve = sr.mean_curve()
        print(f"{'/'.join(sr.key):40s} seed-mean curve "
              f"{[round(float(a), 3) for a in curve]} @ epochs {epochs}")
    print(f"scenario_sweep OK: {len(results)} scenarios x "
          f"{len(spec.seeds)} seeds on {base.device}")
    return results


if __name__ == "__main__":
    main()
