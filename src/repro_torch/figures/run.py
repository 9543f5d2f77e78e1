"""The port's figure campaign CLI: a figure set run through the campaign
runner (``repro_torch.launch.campaign``) — every scenario multi-seed through
the seed-stacked engine, cached in the port's JSONL results store.

  python -m repro_torch.figures.run --campaign smoke                # on the card
  python -m repro_torch.figures.run --campaign smoke --device cpu \\
      --figures fig2 --seeds 0 1 --vehicles 6 --epochs 4 --store /tmp/s.jsonl

(from a bare checkout, prefix with PYTHONPATH=src). The store defaults to
``results/campaign_<tier>_torch.jsonl``; the markdown report is written only
to an explicit ``--results-md PATH``. Neither ever names the reference's
store or ``docs/RESULTS.md``. ``--device`` defaults to ``cuda`` and raises
without a CUDA device.
"""
from __future__ import annotations

import argparse
import time
from typing import Sequence

from ..launch import campaign as campaign_lib
from . import common


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--campaign", choices=("smoke", "full"), default="smoke",
                    help="scale tier")
    ap.add_argument("--figures", nargs="+", default=None,
                    choices=campaign_lib.available_figures(),
                    help=f"figure subset (default: {' '.join(common.DEFAULT_FIGURES)})")
    ap.add_argument("--seeds", nargs="+", type=int, default=None)
    ap.add_argument("--vehicles", type=int, default=None,
                    help="override the tier's vehicle count")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the tier's epoch count")
    ap.add_argument("--store", default=None,
                    help="results-store path (default "
                         "results/campaign_<tier>_torch.jsonl)")
    ap.add_argument("--results-md", default=None,
                    help="write the markdown report here (default: none)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a CUDA device) or cpu")
    ap.add_argument("--force", action="store_true",
                    help="ignore cached store rows and re-run every scenario")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero if any ordering check fails")
    args = ap.parse_args(argv)

    spec = common.campaign_spec(
        tier=args.campaign,
        figures=tuple(args.figures or common.DEFAULT_FIGURES),
        seeds=tuple(args.seeds or common.SMOKE_SEEDS),
        store_path=args.store, results_md=args.results_md, device=args.device,
        **{k: v for k, v in (("num_vehicles", args.vehicles),
                             ("epochs", args.epochs)) if v is not None})
    t0 = time.time()
    results = campaign_lib.run_campaign(spec, force=args.force, progress=True)
    for fr in results:
        print(f"\n### {fr.spec.name}: {fr.spec.title}", flush=True)
        print("\n".join(common.figure_csv(fr)), flush=True)
    n_checks = sum(len(fr.checks) for fr in results)
    n_passed = sum(c.passed for fr in results for c in fr.checks)
    print(f"\n# campaign {spec.name}: {len(results)} figures, "
          f"{n_passed}/{n_checks} ordering checks passed, "
          f"store={spec.store_path}, results_md={spec.results_md}, "
          f"device={spec.base.device}, {time.time() - t0:.1f}s", flush=True)
    if args.strict and n_passed < n_checks:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
