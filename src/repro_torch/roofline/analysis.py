"""Three-term roofline of the dry-run records, on the H100's terms.

Counterpart of ``repro.roofline.analysis``:

  compute term    = per-device flops / peak flop/s of the record's dtype
  memory term     = per-device HBM traffic / HBM bandwidth
  collective term = per-device collective bytes / NVLink bandwidth

plus MODEL_FLOPS = 6*N*D (train) / 2*N_active*D (serve) and the useful-compute
ratio MODEL_FLOPS / (flops_per_device * chips), which shows padding, remat and
dense-MoE waste.

The defaults are one H100 SXM's (``roofline.hw``): the peak for the record's
``dtype`` field (``float32`` when absent: the port trains and serves in f32),
``HBM_BYTES_PER_S`` and ``NVLINK_BYTES_PER_S``. Any term can be passed in;
with the reference's TPU constants the rows are the reference's. The records
of either package's dry run read the same (the fields are the same).

CLI: PYTHONPATH=src python -m repro_torch.roofline.analysis records.jsonl [...] [--json]
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

from ..configs.registry import get_config
from ..launch.shapes import INPUT_SHAPES
from . import hw

PEAK_BY_DTYPE = {
    "float32": hw.F32_FLOP_PER_S,
    "tf32": hw.TF32_FLOP_PER_S,
    "bfloat16": hw.BF16_FLOP_PER_S,
}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    suggestion: str

    def step_time_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


_SUGGESTIONS = {
    "collective": ("shrink or overlap the gossip reduce-scatter: mix on fewer "
                   "columns (bf16 payload), top-k sparsify the mixing row, bucket "
                   "and overlap it with local training, or keep the vehicle axis "
                   "inside one NVLink domain"),
    "memory": ("cut HBM traffic: bf16 parameters / activations, fuse the "
               "element-wise chains into CUDA kernels, larger per-step tiles, or "
               "fewer remat recomputes"),
    "compute": ("cut flops or raise the rate: TF32 / bf16 on the tensor cores, "
                "drop padded-head waste via 2-D model sharding, sorted / ragged "
                "MoE dispatch instead of dense-all-experts, flash attention "
                "instead of materialized S^2"),
}


def analyze_record(rec: dict, *, peak_flops: float | None = None,
                   hbm_bytes_per_s: float | None = None,
                   link_bytes_per_s: float | None = None) -> RooflineRow | None:
    """A record's roofline row (None for a failed or incomplete record)."""
    if "error" in rec or "flops_per_device" not in rec:
        return None
    if peak_flops is None:
        peak_flops = PEAK_BY_DTYPE[rec.get("dtype", "float32")]
    hbm = hw.HBM_BYTES_PER_S if hbm_bytes_per_s is None else hbm_bytes_per_s
    link = hw.NVLINK_BYTES_PER_S if link_bytes_per_s is None else link_bytes_per_s
    mesh = rec.get("mesh", {})
    chips = 1
    for v in mesh.values():
        chips *= v
    comp = rec["flops_per_device"] / peak_flops
    memr = rec["traffic_bytes_per_device"] / hbm
    coll_bytes = sum(rec.get("collective_bytes_per_device", {}).values())
    coll = coll_bytes / link
    terms = {"compute": comp, "memory": memr, "collective": coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = rec["flops_per_device"] * chips
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"],
        mesh="x".join(str(v) for v in mesh.values()), chips=chips,
        compute_s=comp, memory_s=memr, collective_s=coll,
        dominant=dominant, model_flops=mf, hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else float("nan"),
        suggestion=_SUGGESTIONS[dominant],
    )


def load_rows(paths: list[str], **terms) -> list[RooflineRow]:
    rows = []
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = analyze_record(json.loads(line), **terms)
                if row:
                    rows.append(row)
    return rows


def markdown_table(rows: list[RooflineRow]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL_FLOPS | useful ratio |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
            f"{r.model_flops:.2e} | {r.useful_ratio:.3f} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="+", help="JSONL records of a dry run")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(args.paths)
    if args.json:
        print(json.dumps([r.__dict__ for r in rows], indent=1))
    else:
        print(markdown_table(rows))
        print()
        for r in rows:
            print(f"{r.arch} x {r.shape}: {r.dominant}-bound -> {r.suggestion}")


if __name__ == "__main__":
    main()
