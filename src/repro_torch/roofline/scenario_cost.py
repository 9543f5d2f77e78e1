"""Per-scenario analytical cost model: predicted epochs/sec for every
(backend, contact_format, mixing_backend, D_max, K) execution configuration.

Counterpart of ``repro.roofline.scenario_cost``, with the same closed form.
The model composes three ingredients:

* the **counted cost** of one local-train round (``flop_cost.analyze_fn``
  over the port's ``make_local_train_fn``: E SGD steps of one vehicle —
  flops, bytes, parameter payload), cached per (dataset kind, E, B). The
  reference counts the compiled HLO instead (``hlo_cost``), which also
  counts its patch-extraction convolutions as arithmetic: for the same step
  it reports 2.28x (MNIST) / 1.16x (CIFAR-10) the port's flops. Each
  package's host profiles are fitted against its own count;
* **closed-form terms** for everything the round does *across* vehicles: the
  P1 exponentiated-gradient solve (dense ``4 K^3`` vs sparse ``4 K^2 D_max``
  flops per EG step), the gossip model mix (dense ``[K, K] @ [K, P]`` GEMM vs
  the sparse ``D_max``-slot gather), and the state-vector aggregation;
* a **host profile** of a handful of machine constants. ``CI_HOST`` is the
  reference's fit of XLA:CPU against the committed BENCH_engine.json /
  BENCH_scale.json, kept verbatim: the port predicts with it on the CPU, and
  the parity tests hold the port's closed form to the reference's with it.
  ``H100`` is fitted from the port's own runs on the card (``chip_smoke.py``,
  cost-model phase), each constant beside the measurement it comes from.

Four constants the reference lacks, three of them host time of the port's
eager Python that XLA's one program per window does not have; at their
default 0.0 every term is the reference's exactly:

* ``p1_step_host_s``, the host cost of one eager EG step of the P1 solve.
  The reference's sparse step fuses into a few kernels and its dense step
  pays only its GEMM dispatches (``gemm_dispatch_s``); the port's loop
  issues every elementwise op of every step from Python — about 28 device
  launches per step in either format — so on the card both formats' P1 is
  host-bound. The host issues step t+1 while the card runs step t, so a step
  costs the larger of the host cost and the reference's per-step form. The
  sparse solve runs in row blocks of ``core.kl_solver.P1_BLOCK`` vehicles,
  one eager loop each (the reference maps its blocks inside the program),
  so it pays the host cost once per block.
* ``p1_kernel_step_s``, the device time of one EG step of the one-launch P1
  solve (``eg_solve``, one block per vehicle) for one wave of resident
  blocks. On the card ``core.kl_solver.solve_p1_all`` takes that launch
  wherever a vehicle's ``[width, K]`` states fit one block
  (``eg_solve_fits``, mirrored by ``eg_solve_block_bytes``): the solve then
  costs ``p1_steps`` such steps per wave and no host time per step.
* ``contact_host_s_per_vehicle`` and ``contact_host_s_per_pair``, the host
  cost per epoch of the contact stream that feeds every window: the numpy
  mobility process (per vehicle) and the pairwise contact matrix and its
  packing (per pair of vehicles), added to the per-epoch overhead. At K=1024
  it takes a larger share of an epoch on the card than all the device work.

``resolve_auto`` turns the model into the ``SimulationConfig.execution =
"auto"`` knob: enumerate the feasible candidates for this host, predict each,
return the winner plus a JSON-able plan (recorded in the campaign results
store). The CLI renders the predicted-vs-measured table of the committed
benchmarks::

    python -m repro_torch.roofline.scenario_cost --out results/cost_model_table_torch.md
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

from . import hw

# ------------------------------------------------------------------ profiles


@dataclass(frozen=True)
class HostProfile:
    """The machine constants the closed-form terms consume.

    ``shard_parallel_fraction`` is the Amdahl fraction of per-epoch compute
    that actually parallelizes across shards.
    """
    name: str
    train_flops_per_s: float      # effective local-train rate (fw+bw, stacked)
    eval_flops_per_s: float       # forward-only batched eval rate
    gemm_flops_per_s: float       # dense GEMM rate ([K,K] @ [K,P] mixes, P1)
    gemm_dispatch_s: float        # per-GEMM-call launch latency
    stream_bytes_per_s: float     # gather / elementwise streaming bandwidth
    epoch_overhead_s: float       # fixed per-epoch cost outside the terms
    collective_launch_s: float    # per-collective rendezvous (shard_map)
    collective_bytes_per_s: float # reduce-scatter payload bandwidth
    shard_parallel_fraction: float
    cuda_mix_gain: float = 1.0    # sparse-mix bandwidth gain from the kernel
    # fraction of the reduce-scatter wire time hidden behind the co-issued
    # partial products (the pipelined bucketed mix): 0 = fully synchronous
    overlap_fraction: float = 0.0
    # host seconds of one eager EG step of the P1 solve, either format; a
    # step costs max(this x row blocks, the reference's per-step form).
    # 0 = the reference
    p1_step_host_s: float = 0.0
    # device seconds of one EG step of the one-launch P1 solve for one wave
    # of resident blocks, where a vehicle's states fit one block. 0 = no such
    # route (the reference)
    p1_kernel_step_s: float = 0.0
    # host seconds per epoch of the contact stream, per vehicle (mobility)
    # and per pair of vehicles (contact matrix, packing), added to
    # epoch_overhead_s. 0 = the reference
    contact_host_s_per_vehicle: float = 0.0
    contact_host_s_per_pair: float = 0.0

    def shard_speedup(self, num_shards: int) -> float:
        f = self.shard_parallel_fraction
        return 1.0 / ((1.0 - f) + f / max(num_shards, 1))


# The reference's profile, verbatim (repro.roofline.scenario_cost.CI_HOST):
# its fit of XLA:CPU on the 2-core CI-class host against the committed
# BENCH_engine.json / BENCH_scale.json rows. The port predicts with it on the
# CPU; the parity tests hold the port's closed form to the reference's with it.
CI_HOST = HostProfile(
    name="ci_host",
    train_flops_per_s=4.5e9,
    eval_flops_per_s=9.0e9,
    gemm_flops_per_s=70e9,        # measured dense-mix GEMM rate (docs/SCALING.md)
    gemm_dispatch_s=45e-6,        # fitted: dense P1 penalty at K=8
    stream_bytes_per_s=25.6e9,
    epoch_overhead_s=2e-4,
    collective_launch_s=3.4e-3,   # fitted: bucketed shard_map overhead / 5
    collective_bytes_per_s=0.2e9,   # measured: BENCH_collective.json derived
    shard_parallel_fraction=0.174,  # fitted: speedup(4) = 1.15 on one socket
    overlap_fraction=0.57,          # measured: BENCH_collective.json derived
)

# One NVIDIA H100 80GB HBM3 at 700 W, fitted from the port's own runs:
# chip_smoke.py's cost-model phase (fit_h100_profile) over its DDS main path
# at the paper's configuration (K=100, E=8, B=80, 200 P1 steps, 4 epochs,
# sparse and dense), its kernels line, its P1 facts, the contact stream at
# K=100 and 1024 and its sharded phase. The collective constants are gloo
# staged through host memory with N ranks sharing one card (the only
# transport measured), not NCCL. PERF.md (cost model) lists each constant
# beside the run that measured it.
H100 = HostProfile(
    name="h100",
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): K x flops per vehicle
    # round over the local_train span per epoch
    train_flops_per_s=2.19342e12,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the model's eval flops
    # over the eval span per evaluating epoch
    eval_flops_per_s=2.11824e12,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): 2 K^2 P over the
    # gossip_mix_matmul row of the kernels line (K=100, one grouped launch)
    gemm_flops_per_s=1.80365e13,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the eager P1 solve's
    # wall time over its device events (K=100, 5,607 events)
    gemm_dispatch_s=1.07968e-5,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the model's sparse-mix
    # bytes over the gossip_mix_gather row's plain version
    stream_bytes_per_s=1.55608e12,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): wall s/epoch minus the
    # phase spans minus the contact stream (K=100)
    epoch_overhead_s=3.60599e-3,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the sharded phase's
    # reduce_scatter per round at N = 2 and 4, solved for launch and rate.
    # gloo staged through host memory with the ranks sharing one card
    collective_launch_s=3.29917e-3,
    collective_bytes_per_s=2.14324e8,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): a rank's epoch at N=2
    # is slower than the vmap epoch (the ranks share one card): clamped at 0
    shard_parallel_fraction=0.0,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the gather row's plain
    # version over its kernel time
    cuda_mix_gain=13.3924,
    # gloo staged through host memory is synchronous: the partial sums reach
    # the host before the collective starts, so nothing hides behind it
    overlap_fraction=0.0,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the p1_solve span per
    # EG step, mean of the sparse and dense runs (K=100, one block)
    p1_step_host_s=2.80815e-4,
    # (H100 80GB HBM3 at 700.00 W): eg_solve on the ids of a K=100 contact
    # stream (D_max = 11), 0.3798 ms for 200 steps, one wave (chip_smoke.py's
    # kernels line, row eg_solve id_table)
    p1_kernel_step_s=1.899e-6,
    # (chip_smoke.py, H100 80GB HBM3 at 700.00 W): the contact stream
    # timed on the host at K=100 (4.86 ms/epoch) and K=1024 (135.8 ms/epoch)
    contact_host_s_per_vehicle=3.954e-5,
    contact_host_s_per_pair=9.09e-8,
)


def default_host_profile(device: str) -> HostProfile:
    """``H100`` for a CUDA device (``"cuda"``, ``"cuda:N"``), ``CI_HOST``
    otherwise. Names a device; needs no card."""
    return H100 if str(device).startswith("cuda") else CI_HOST


# ------------------------------------------------- counted local-train cost

@lru_cache(maxsize=8)
def local_train_stats(dataset: str, local_steps: int, batch_size: int) -> dict:
    """Counted cost of ONE vehicle's local-train round: flops, bytes,
    parameter count and leaf count, via ``flop_cost.analyze_fn`` over the
    port's ``make_local_train_fn`` (E SGD steps, dropout on), run once on the
    CPU on zero inputs."""
    import torch

    from ..fed.engine import make_local_train_fn
    from ..models import cnn as cnn_lib
    from ..optim import sgd
    from . import flop_cost

    kind = "cifar10" if "cifar" in dataset else "mnist"
    h, w, c = (32, 32, 3) if kind == "cifar10" else (28, 28, 1)
    init_fn, loss_fn, _ = cnn_lib.make_cnn_task(kind)
    optimizer = sgd(0.1)
    train = make_local_train_fn(loss_fn, optimizer)

    params = {name: p[None] for name, p in
              init_fn(torch.Generator().manual_seed(0)).items()}   # K = 1
    opt_state = optimizer.init(params, num_stacked=1)
    xs = torch.zeros((1, local_steps, batch_size, h, w, c), dtype=torch.float32)
    ys = torch.zeros((1, local_steps, batch_size), dtype=torch.long)
    cost = flop_cost.analyze_fn(train, params, opt_state, (xs, ys),
                                torch.Generator().manual_seed(0))
    return {
        "flops": float(cost["flops_per_device"]),
        "traffic_bytes": float(cost["traffic_bytes_per_device"]),
        "params": int(sum(p.numel() for p in params.values())),
        "leaves": int(len(params)),
    }


# ------------------------------------------------------- closed-form terms

# bytes of elementwise work per alpha element per EG step (~12 f32 passes:
# gradient combine, exp, clip, renormalize — see core/kl_solver.py)
EG_ELEMWISE_BYTES = 48.0
# bytes the sparse slot-scan mix streams per (edge x param): gather the
# neighbour row + read/write the accumulator
MIX_SLOT_BYTES = 12.0


def eg_solve_block_bytes(d: int, k: int) -> int:
    """Shared memory one block of ``eg_solve`` takes for ``[d, k]`` states:
    ``solve_smem_bytes`` of ``kernels/kl_simplex/csrc/eg_solve.cu`` (the u
    partial sums of 8 warps, r and log g over K; alpha and the grad slices
    over D; S at its bank-conflict-free pitch), mirrored here so that the
    model needs no card; the card's tests hold the two equal."""
    def pitch4(n: int) -> int:
        return (n + 3) & ~3
    pitch = pitch4(k) if (pitch4(k) // 4) % 2 == 1 else pitch4(k) + 4
    groups = (d + 31) // 32
    splits = 1 if groups >= 8 else 8 // groups
    return 4 * (10 * pitch4(k) + (1 + splits) * pitch4(d) + d * pitch)


def eg_solve_waves(K: int, width: int) -> int | None:
    """Waves of resident blocks the one-launch P1 solve takes on an H100 for
    K vehicles of ``[width, K]`` states (256 threads and one block a
    vehicle; 1 KB of shared memory reserved a block), or None where the
    states do not fit one block and the eager loop runs."""
    block = eg_solve_block_bytes(width, K)
    if not (1 <= width <= 1024 and 1 <= K <= 1024 and block <= hw.SMEM_BYTES_PER_BLOCK):
        return None
    per_sm = min(hw.THREADS_PER_SM // 256, hw.SMEM_BYTES_PER_SM // (block + 1024))
    return -(-K // (hw.SMS * per_sm))


def _p1_epoch_s(K: int, width: int, p1_steps: int, dense: bool,
                host: HostProfile) -> float:
    """P1 solve (Eq. 11, exponentiated gradient): per EG step each vehicle
    contracts its ``width`` active state rows twice (mixed state + gradient)
    — ``width = K`` dense, ``D_max`` sparse. On a host with the one-launch
    solve (``p1_kernel_step_s``) whose block takes the states, ``p1_steps``
    kernel steps per wave. Otherwise the eager loop: the dense path runs as 2
    GEMM calls per step (flop-bound at large K, dispatch-bound at small K);
    the sparse path as a bandwidth-bound gather over the neighbour rows. A
    step costs at least the host's ``p1_step_host_s``, once per row block of
    the sparse solve."""
    from ..core.kl_solver import P1_BLOCK

    waves = eg_solve_waves(K, width) if host.p1_kernel_step_s > 0 else None
    if waves is not None:
        return p1_steps * host.p1_kernel_step_s * waves

    flops = 4.0 * K * width * K
    if dense:
        step = (flops / host.gemm_flops_per_s + 2.0 * host.gemm_dispatch_s
                + EG_ELEMWISE_BYTES * K * K / host.stream_bytes_per_s)
        blocks = 1
    else:
        step = (flops / host.gemm_flops_per_s
                + (4.0 * K * width * K + EG_ELEMWISE_BYTES * K * width)
                / host.stream_bytes_per_s)
        blocks = -(-K // P1_BLOCK)
    return p1_steps * max(step, blocks * host.p1_step_host_s)


def _mix_epoch_s(K: int, d_max: int, params: int, dense: bool,
                 host: HostProfile, cuda: bool) -> float:
    """Gossip model mix (Eq. 10): dense is one ``[K, K] @ [K, P]`` GEMM;
    sparse is the D_max-slot gather over the padded neighbour lists."""
    if dense:
        return (2.0 * K * K * params / host.gemm_flops_per_s
                + host.gemm_dispatch_s
                + 4.0 * (K * K + 2.0 * K * params) / host.stream_bytes_per_s)
    bw = host.stream_bytes_per_s * (host.cuda_mix_gain if cuda else 1.0)
    return MIX_SLOT_BYTES * K * d_max * params / bw


def _state_epoch_s(K: int, d_max: int, dense: bool, host: HostProfile) -> float:
    """State-vector aggregation (Eqs. 5-7): the [K] vectors mix over the same
    contact structure as the models — one more (tiny) contraction."""
    if dense:
        return (2.0 * K * K * K / host.gemm_flops_per_s + host.gemm_dispatch_s
                + 8.0 * K * K / host.stream_bytes_per_s)
    return 8.0 * K * d_max * K / host.stream_bytes_per_s


def _divisor_shards(total_nodes: int, max_shards: int) -> int:
    """Largest shard count <= max_shards dividing the vehicle axis evenly —
    the arithmetic core of ``fed.backends.vehicle_shards``, without the
    process-group cap (predictions may target other hosts)."""
    limit = max(1, min(max_shards, total_nodes))
    return max(d for d in range(1, limit + 1) if total_nodes % d == 0)


@dataclass(frozen=True)
class CostBreakdown:
    """One candidate's predicted per-epoch cost, term by term (seconds)."""
    backend: str
    contact_format: str
    mixing_backend: str
    d_max: int
    device_count: int
    num_shards: int
    terms: dict[str, float]

    @property
    def total_s(self) -> float:
        return sum(self.terms.values())

    @property
    def epochs_per_s(self) -> float:
        return 1.0 / self.total_s

    def jsonable(self) -> dict:
        return {
            "backend": self.backend, "contact_format": self.contact_format,
            "mixing_backend": self.mixing_backend, "d_max": self.d_max,
            "device_count": self.device_count, "num_shards": self.num_shards,
            "terms_s": {k: round(v, 9) for k, v in self.terms.items()},
            "total_s": round(self.total_s, 9),
            "predicted_epochs_per_s": round(self.epochs_per_s, 4),
        }


def predict_scenario(cfg, *, d_max: int, device_count: int = 1,
                     host: HostProfile | None = None,
                     dataset: str | None = None) -> CostBreakdown:
    """Predicted per-epoch cost of running ``cfg`` as-is (its backend /
    contact_format / mixing_backend taken literally). ``d_max`` is the
    resolved sparse slot budget (callers resolve it once — pin, density, or
    probe — and share it across candidates)."""
    from ..core import vehicle_axis

    host = host or default_host_profile(cfg.device)
    stats = local_train_stats(dataset or cfg.dataset, cfg.local_steps,
                              cfg.batch_size)
    K = cfg.num_vehicles + cfg.num_rsus
    dense = cfg.contact_format == "dense"
    width = K if dense else min(d_max, K)
    cuda = cfg.mixing_backend == "cuda"

    terms = {"overhead": host.epoch_overhead_s + K * host.contact_host_s_per_vehicle
             + K * K * host.contact_host_s_per_pair}
    terms["train"] = K * stats["flops"] / host.train_flops_per_s
    if cfg.algorithm == "dds":
        terms["p1"] = _p1_epoch_s(K, width, cfg.p1_steps, dense, host)
    terms["mix"] = _mix_epoch_s(K, width, stats["params"], dense, host, cuda)
    terms["state"] = _state_epoch_s(K, width, dense, host)
    # evals amortized over the run: fwd-only, ~1/3 of the per-sample fw+bw
    # flops, on every eval_every-th epoch plus the final one
    per_sample_fwd = stats["flops"] / (3.0 * cfg.local_steps * cfg.batch_size)
    evals = cfg.epochs // max(cfg.eval_every, 1) + 1
    terms["eval"] = (evals * K * cfg.eval_samples * per_sample_fwd
                     / host.eval_flops_per_s / max(cfg.epochs, 1))

    shards = 1
    if cfg.backend == "shard_map":
        shards = _divisor_shards(K, device_count)
        speedup = host.shard_speedup(shards)
        for k in ("train", "p1", "mix", "state", "eval"):
            if k in terms:
                terms[k] /= speedup
        if shards > 1:
            # mix reduce-scatters (per-leaf, or the bucketed packing) + the
            # group means
            bucket_mb = getattr(cfg, "comm_bucket_mb", 0.0)
            n_mix = vehicle_axis.num_comm_buckets(
                4.0 * K * stats["params"], bucket_mb, stats["leaves"])
            wire_s = (vehicle_axis.psum_scatter_bytes(
                K, 4 * stats["params"], shards) / host.collective_bytes_per_s)
            # bucketed payloads pipeline against the partial products, hiding
            # the measured overlap fraction of the wire time; the per-leaf
            # path (bucketing off) overlaps nothing
            hidden = host.overlap_fraction if bucket_mb > 0 else 0.0
            terms["collective"] = ((n_mix + 4) * host.collective_launch_s
                                   + wire_s * (1.0 - hidden))

    return CostBreakdown(
        backend=cfg.backend, contact_format=cfg.contact_format,
        mixing_backend=cfg.mixing_backend, d_max=width,
        device_count=device_count, num_shards=shards, terms=terms)


# ------------------------------------------------------- execution = "auto"

def _resolve_candidate_d_max(cfg) -> int:
    """The sparse slot budget, via the same pin -> density -> probe chain as
    ``engine.ContactStream`` (the probe replays the exact contact stream)."""
    import numpy as np

    total = cfg.num_vehicles + cfg.num_rsus
    if cfg.d_max > 0:
        return min(cfg.d_max, total)
    if cfg.contact_density is not None:
        return max(1, min(total, int(np.ceil(cfg.contact_density * total))))
    from ..fed import engine as engine_lib
    from ..fed import topology as topology_lib

    net = topology_lib.make_road_network(cfg.road_net, seed=cfg.seed)
    return engine_lib.probe_d_max(cfg, net)


def enumerate_candidates(cfg, device_count: int, host: HostProfile):
    """Feasible (backend, contact_format, mixing_backend) combinations for
    this fleet and device count, as concrete configs."""
    total = cfg.num_vehicles + cfg.num_rsus
    backends = ["vmap"]
    if device_count > 1 and _divisor_shards(total, device_count) > 1:
        backends.append("shard_map")
    mixings = [cfg.mixing_backend]
    if host.cuda_mix_gain > 1.0 and "cuda" not in mixings:
        mixings.append("cuda")
    return [replace(cfg, execution="manual", backend=be, contact_format=fmt,
                    mixing_backend=mx)
            for be in backends for fmt in ("sparse", "dense")
            for mx in mixings]


def resolve_auto(cfg, *, device_count: int | None = None,
                 host: HostProfile | None = None):
    """Resolve an ``execution="auto"`` config to the predicted-fastest
    concrete configuration. Returns ``(resolved_cfg, plan)`` where ``plan``
    is a JSON-able record of the choice: the resolved knobs, the prediction,
    and every candidate's breakdown (stored in the campaign results row).

    ``device_count`` defaults to the ranks of the default process group
    (``launch.mesh.world_size``): a shard of the shard_map backend is a
    process, as ``fed.backends.vehicle_shards`` counts them. ``host``
    defaults to the profile of ``cfg.device``."""
    from ..launch import mesh as mesh_lib

    host = host or default_host_profile(cfg.device)
    if device_count is None:
        device_count = mesh_lib.world_size()
    d_max = _resolve_candidate_d_max(cfg)

    scored = []
    for cand in enumerate_candidates(cfg, device_count, host):
        bd = predict_scenario(cand, d_max=d_max, device_count=device_count,
                              host=host)
        scored.append((cand, bd))
    best_cfg, best_bd = max(scored, key=lambda cb: cb[1].epochs_per_s)
    if best_cfg.contact_format == "sparse":
        best_cfg = replace(best_cfg, d_max=d_max)  # pin: skip the re-probe
    plan = {
        "requested": "auto",
        "host_profile": host.name,
        "device_count": int(device_count),
        "resolved": {
            "backend": best_cfg.backend,
            "contact_format": best_cfg.contact_format,
            "mixing_backend": best_cfg.mixing_backend,
            "d_max": int(d_max),
            "num_shards": best_bd.num_shards,
        },
        "predicted_epochs_per_s": round(best_bd.epochs_per_s, 4),
        "candidates": [bd.jsonable() for _, bd in scored],
    }
    return best_cfg, plan


# --------------------------------------------- committed-benchmark replay

# Ranking tolerance: a measured pair whose faster/slower ratio is within
# NEAR_TIE_RATIO is a near-tie — the model may predict either order there,
# but its predicted ratio must stay inside the LOOSE_RATIO band. Decisive
# pairs require the predicted winner to match the measured winner.
NEAR_TIE_RATIO = 1.15
LOOSE_RATIO = 1.5


def ranking_verdict(measured_ratio: float, predicted_ratio: float) -> str:
    """'ok' (signs agree), 'tie-ok' (measured near-tie, prediction in the
    loose band), or 'MISMATCH'. Ratios are faster-is-greater-than-1 of the
    same configuration pair in the same order."""
    if 1.0 / NEAR_TIE_RATIO <= measured_ratio <= NEAR_TIE_RATIO:
        return ("tie-ok" if 1.0 / LOOSE_RATIO <= predicted_ratio <= LOOSE_RATIO
                else "MISMATCH")
    same_side = (measured_ratio > 1.0) == (predicted_ratio > 1.0)
    return "ok" if same_side else "MISMATCH"


def pair_row(pair: str, measured_a: float, measured_b: float,
             predicted_a: CostBreakdown, predicted_b: CostBreakdown,
             **extra) -> dict:
    """One predicted-vs-measured row of a configuration pair (a against b,
    epochs per second), with its ranking verdict."""
    measured_ratio = float(measured_a) / float(measured_b)
    predicted_ratio = predicted_a.epochs_per_s / predicted_b.epochs_per_s
    return {
        "pair": pair, **extra,
        "measured_a": float(measured_a),
        "measured_b": float(measured_b),
        "predicted_a": round(predicted_a.epochs_per_s, 4),
        "predicted_b": round(predicted_b.epochs_per_s, 4),
        "measured_ratio": round(measured_ratio, 3),
        "predicted_ratio": round(predicted_ratio, 3),
        "verdict": ranking_verdict(measured_ratio, predicted_ratio),
    }


def bench_engine_config(num_vehicles: int):
    """The BENCH_engine.json workload (the reference's, field for field)."""
    from ..fed.engine import SimulationConfig

    return SimulationConfig(
        algorithm="dds", num_vehicles=num_vehicles,
        epochs=48 if num_vehicles == 8 else 8,
        eval_every=1_000, eval_samples=100, local_steps=1, batch_size=4,
        p1_steps=40, lr=0.15, seed=0)


def bench_scale_config(num_vehicles: int, contact_format: str, epochs: int,
                       d_max: int = 0):
    """The BENCH_scale.json workload (the reference's, field for field; the
    road net ``scale_grid`` is registered by whoever runs it, with grid side
    ``round(sqrt(K))``)."""
    from ..fed.engine import SimulationConfig

    return SimulationConfig(
        algorithm="dds", num_vehicles=num_vehicles, epochs=epochs,
        road_net="scale_grid", eval_every=10 * epochs, eval_samples=4,
        local_steps=1, batch_size=1, lr=0.15, seed=0,
        contact_format=contact_format, d_max=d_max)


def replay_bench_engine(report: dict,
                        host: HostProfile | None = None) -> list[dict]:
    """Predict every BENCH_engine.json row (vmap vs shard_map pair) and
    attach the ranking verdict. The sparse slot budget is re-probed on the
    workload's own contact stream (the benchmark never records it)."""
    host = host or CI_HOST
    device_count = int(report["device_count"])
    rows = []
    for r in report["results"]:
        cfg = bench_engine_config(int(r["num_vehicles"]))
        d_max = _resolve_candidate_d_max(cfg)
        pv = predict_scenario(replace(cfg, backend="vmap"), d_max=d_max,
                              device_count=device_count, host=host)
        ps = predict_scenario(replace(cfg, backend="shard_map"), d_max=d_max,
                              device_count=device_count, host=host)
        rows.append(pair_row(
            f"shard_map-vs-vmap K={r['num_vehicles']}",
            r["shard_map_epochs_per_s"], r["vmap_epochs_per_s"], ps, pv,
            num_vehicles=int(r["num_vehicles"])))
    return rows


def replay_bench_scale(report: dict,
                       host: HostProfile | None = None) -> list[dict]:
    """Predict every BENCH_scale.json (K, sparse-vs-dense) pair using the
    recorded epochs and D_max, and attach the ranking verdict."""
    host = host or CI_HOST
    cells = {(int(r["num_vehicles"]), r["contact_format"]): r
             for r in report["results"]}
    rows = []
    for k in sorted({int(r["num_vehicles"]) for r in report["results"]}):
        dense_r, sparse_r = cells[(k, "dense")], cells[(k, "sparse")]
        epochs, d_max = int(sparse_r["epochs"]), int(sparse_r["d_max"])
        pd = predict_scenario(
            bench_scale_config(k, "dense", epochs), d_max=d_max, host=host)
        ps = predict_scenario(
            bench_scale_config(k, "sparse", epochs, d_max=d_max), d_max=d_max,
            host=host)
        rows.append(pair_row(
            f"sparse-vs-dense K={k}", sparse_r["epochs_per_s"],
            dense_r["epochs_per_s"], ps, pd, num_vehicles=k, d_max=d_max))
    return rows


def predicted_vs_measured_table(engine_rows: list[dict], scale_rows: list[dict],
                                profile: str = "ci_host") -> str:
    """Markdown predicted-vs-measured table of the pairs' rows, under the
    name of the host profile that predicted them."""
    lines = [
        f"# Cost model: predicted vs measured (profile: {profile})",
        "",
        "Ratios are (first config) / (second config) epochs-per-sec; a pair",
        f"is a near-tie when the measured ratio is within {NEAR_TIE_RATIO}x.",
        "",
        "| pair | measured eps (a/b) | predicted eps (a/b) "
        "| measured ratio | predicted ratio | verdict |",
        "|---|---|---|---|---|---|",
    ]
    for r in engine_rows + scale_rows:
        lines.append(
            f"| {r['pair']} | {r['measured_a']:.3f} / {r['measured_b']:.3f} "
            f"| {r['predicted_a']:.3f} / {r['predicted_b']:.3f} "
            f"| {r['measured_ratio']:.3f} | {r['predicted_ratio']:.3f} "
            f"| {r['verdict']} |")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    import argparse
    import os

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--engine-json", default="BENCH_engine.json")
    ap.add_argument("--scale-json", default="BENCH_scale.json")
    ap.add_argument("--out", default="results/cost_model_table_torch.md")
    args = ap.parse_args(argv)

    from . import bench_schema

    engine_rows = replay_bench_engine(
        bench_schema.load_engine_report(args.engine_json))
    scale_rows = replay_bench_scale(
        bench_schema.load_scale_report(args.scale_json))
    table = predicted_vs_measured_table(engine_rows, scale_rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(table)
    print(table)
    bad = [r for r in engine_rows + scale_rows if r["verdict"] == "MISMATCH"]
    if bad:
        print(f"RANKING MISMATCH on {len(bad)} pair(s): "
              + ", ".join(r["pair"] for r in bad))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
