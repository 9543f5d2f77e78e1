"""The simulation engine: whole epoch windows of DFL-DDS rounds.

Counterpart of ``repro.fed.engine`` (its fused scan engine):

* **Contact-window precompute** — the mobility process stays host-side (it
  is inherently sequential) but is batched up front: ``ContactStream.window(T)``
  advances T epochs of motion and converts the stacked [T, K, 2] position
  snapshots into the contact representation the run's ``contact_format``
  names (core.contacts registry): padded neighbour lists [T, K, D_max] (the
  sparse default) or the dense [T, K, K] contact tensor — including RSU
  relays and Bernoulli edge drops either way. The stream consumes its RNGs
  epoch by epoch, so trajectories are independent of window chunking AND of
  the contact format.

* **Window loop** — where the reference scans a window with ``lax.scan``,
  the port runs a Python loop over its epochs, every tensor staying on the
  run's device and nothing synchronising until the window's trajectory is
  read back: per epoch it gathers per-vehicle minibatches, applies the
  algorithm round (P1 solve, gossip mix, local training, state-vector
  update) and evaluates accuracy + consensus distance on the epochs the eval
  mask selects.

* **Seed axis** — ``run_seeds`` stacks S independent federations (their own
  partitions, mobility traces, model inits and random generators) on a
  leading seed axis and runs ONE window loop for all of them
  (``stack_contexts``): the rounds take the seed axis as written out in
  ``core``, the CNN trains the ``[S * K]`` folded stack, and each gossip-mix
  kernel launches once per round for every seed.

* **Delayed gossip** — ``overlap="delayed"`` carries ``(algorithm state,
  stale params)`` through the window (``build_window_fn``'s
  ``delayed_round``; ``core.vehicle_axis.delayed_gossip_mix``).

* **Vehicle-sharded runs** — under the shard_map backend
  (``fed.backends.ShardMapBackend``) each process holds a row block of the
  vehicle axis: ``EngineContext.bind`` wraps the mix in
  ``core.vehicle_axis.sharded_mix`` and cuts the initial state by the
  algorithm's ``state_spec``, and the window computes consensus over the
  group and all-gathers the per-vehicle accuracy rows.

``simulator.run_legacy_loop`` (``use_scan_engine=False``) is the per-epoch
loop the engine is held against.

``SimulationConfig.device`` names where a run lives: ``"cuda"`` by default
(raising when there is no CUDA device — nothing falls back to the CPU on its
own), ``"cpu"`` when the caller asks for it, as the tests do.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import convert
from ..core import aggregation, state_vector, vehicle_axis
from ..core import contacts as contacts_lib
from ..data import datasets as data_lib
from ..data import pipeline
from ..kernels.gossip_mix import ops as gossip_ops
from ..models import cnn as cnn_lib
from ..optim import ScaleState, apply_updates, sgd
from ..precision import full_f32_matmul
from ..profiling import PhaseTimer, phase
from . import algorithms as algorithms_lib
from . import extensions as extensions_lib
from . import mobility as mobility_lib
from . import partition as partition_lib
from . import topology as topology_lib

Tensor = torch.Tensor

# samples per forward pass of the in-run evaluation: bounds the im2col
# buffers of K stacked models over a large eval set
EVAL_CHUNK = 250


@dataclass
class SimulationConfig:
    algorithm: str = "dds"            # any registered algorithm (fed.algorithms)
    dataset: str = "mnist"            # mnist | cifar10
    road_net: str = "grid"            # any registered road network (fed.topology)
    distribution: str = "balanced_noniid"  # balanced_noniid | unbalanced_iid
    num_vehicles: int = 100
    epochs: int = 300
    lr: float = 0.1                   # paper Table II
    local_steps: int = 8              # E
    batch_size: int = 80              # B
    comm_range: float = 100.0
    epoch_duration: float = 30.0
    eval_every: int = 10
    eval_samples: int = 2000
    p1_steps: int = 200
    p1_step_size: float = 2.0
    seed: int = 0
    mobility: str = "manhattan"       # any registered mobility model (fed.mobility)
    # contact-window representation (core.contacts registry): "sparse" packs
    # each epoch's graph into padded neighbour lists [T, K, D_max] — the
    # default; "dense" keeps the [T, K, K] matrices. Trajectories are
    # format-independent (parity-tested to tolerance).
    contact_format: str = "sparse"
    # neighbour-slot budget for the sparse format: d_max pins the slot count
    # directly; contact_density sizes it as a fleet fraction (ceil(density *
    # K)); with both unset, a probe replays the exact contact stream and
    # picks the run's true maximum contact-set size (no overflow possible).
    # Overflowing an explicit budget is a loud error, never a truncation.
    d_max: int = 0
    contact_density: float | None = None
    # how the gossip mix W @ w executes: "cuda" (the hand-written gossip_mix
    # kernels; the default, and the one default that differs from the
    # reference's "jnp") | "torch" (core.aggregation.mix_params, plain tensor
    # operations). On a CPU run "cuda" takes the kernels' plain versions.
    mixing_backend: str = "cuda"
    # the shard_map backend's reduce-scatter buckets: MiB of a rank's own
    # parameter rows packed into one collective (core.vehicle_axis
    # .sharded_mix); 0 = one per leaf. The vmap backend never reads it.
    comm_bucket_mb: float = 4.0
    # "sync" mixes each round's own params (paper Eq. 10). "delayed" double-
    # buffers the exchange: round t's neighbour payloads are the params that
    # were on the air while round t trained — one round stale — while each
    # vehicle's own contribution stays current (core.vehicle_axis
    # .delayed_gossip_mix). A semantic knob; window engine only.
    overlap: str = "sync"
    # extensions (paper Sec. V-C / Sec. VII): data-less static RSUs join the
    # federation as relays; V2V exchanges fail with probability p_drop
    num_rsus: int = 0
    p_drop: float = 0.0
    # engine controls: window_size = 0 runs the whole horizon as one window;
    # > 0 chunks it (bounds host memory for the contact window on very long
    # runs). use_scan_engine=False runs the per-epoch loop
    # (simulator.run_legacy_loop), the parity reference of the engine.
    use_scan_engine: bool = True
    window_size: int = 0
    # execution backend (fed.backends): "vmap" = the whole federation stacked
    # on one device; "shard_map" = the vehicle axis split over the processes
    # of a torch.distributed group, one row block each (the names are the
    # reference's)
    backend: str = "vmap"
    # "manual" runs the knobs above exactly as set; "auto" resolves backend /
    # contact_format / mixing_backend / d_max from the analytical cost model
    # (roofline.scenario_cost) before anything runs — trajectory-neutral
    execution: str = "manual"
    # where the run lives: "cuda" (or "cuda:N") | "cpu". Never falls back.
    device: str = "cuda"


def resolve_device(cfg: SimulationConfig) -> torch.device:
    """The run's device; ``"cuda"`` without a CUDA device raises."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SimulationConfig.device={cfg.device!r} but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return device


def check_supported(cfg: SimulationConfig) -> None:
    """Raise on configuration values the engine does not know."""
    if cfg.overlap not in ("sync", "delayed"):
        raise ValueError(f"unknown overlap {cfg.overlap!r} (sync|delayed)")
    if cfg.execution not in ("manual", "auto"):
        raise ValueError(f"unknown execution {cfg.execution!r} (manual|auto)")


def resolve_execution(cfg: SimulationConfig) -> tuple[SimulationConfig, dict | None]:
    """Resolve ``execution="auto"`` to a concrete configuration via the
    analytical cost model (roofline.scenario_cost) — no-op for "manual".
    Returns ``(resolved config, plan)``; the plan records the choice and is
    stamped on results / campaign rows."""
    check_supported(cfg)
    if cfg.execution != "auto":
        return cfg, None
    from ..roofline import scenario_cost

    return scenario_cost.resolve_auto(cfg)


def resolve_mix_params_fn(cfg: SimulationConfig) -> Callable:
    """The gossip-mix implementation named by the ``mixing_backend`` knob."""
    if cfg.mixing_backend == "torch":
        return aggregation.mix_params
    if cfg.mixing_backend == "cuda":
        return gossip_ops.mix_params_cuda
    raise ValueError(
        f"unknown mixing_backend {cfg.mixing_backend!r} (torch|cuda)")


@dataclass
class SimulationResult:
    config: SimulationConfig
    epochs_evaluated: list[int] = field(default_factory=list)
    avg_accuracy: list[float] = field(default_factory=list)
    vehicle_accuracy: list[np.ndarray] = field(default_factory=list)   # [K] per eval
    entropy: list[np.ndarray] = field(default_factory=list)            # [K] per eval
    kl_divergence: list[np.ndarray] = field(default_factory=list)      # [K] per eval
    consensus_distance: list[float] = field(default_factory=list)
    # full per-epoch traces (every global epoch, not just eval epochs):
    # mean state-vector KL-to-target (the paper's diversity measure, Eq. 9)
    # and the communication volume of that round's V2V exchanges in MB
    kl_trace: list[float] = field(default_factory=list)
    comm_mb: list[float] = field(default_factory=list)
    wall_time: float = 0.0
    execution_plan: dict | None = None   # set by execution="auto"

    def final_accuracy(self) -> float:
        return self.avg_accuracy[-1] if self.avg_accuracy else float("nan")

    def total_comm_mb(self) -> float:
        return float(np.sum(self.comm_mb)) if self.comm_mb else 0.0


def model_payload_bytes(params_stack: dict) -> int:
    """Bytes of ONE vehicle's flattened model (the stack divided by its
    leading vehicle axis) — the parameter payload of a single V2V exchange."""
    return sum(l.numel() // l.shape[0] * l.element_size()
               for l in params_stack.values())


def exchange_payload_mb(ctx: "EngineContext") -> float:
    """MB one directed V2V exchange ships: the model plus the [K] state
    vector (paper Sec. V-A: vehicles exchange both every contact)."""
    params = ctx.setup.params_stack
    if ctx.num_seeds:                       # [S, K, ...]: one seed's stack
        params = {name: leaf[0] for name, leaf in params.items()}
    return (model_payload_bytes(params) + ctx.total_nodes * 4) / 1e6


def make_local_train_fn(loss_fn, optimizer):
    """E local SGD steps (Eq. 3) for ALL K vehicles at once.

    ``loss_fn(params, x, y, generator)`` returns the ``[K]`` per-vehicle mean
    losses of a stacked forward. Vehicle k's weights enter only loss k, so
    the gradient of the SUM over vehicles with respect to the stacked weights
    is, row by row, each vehicle's own gradient: one backward pass per local
    step serves the whole stack.
    """

    def local_train(params, opt_state, batch, generator):
        xs, ys = batch  # [K, E, B, ...], [K, E, B]
        steps = xs.shape[1]
        losses = []
        for e in range(steps):
            with torch.enable_grad():
                leaves = {name: p.detach().requires_grad_(True)
                          for name, p in params.items()}
                loss = loss_fn(leaves, xs[:, e], ys[:, e], generator)   # [K]
                grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
            updates, opt_state = optimizer.update(
                dict(zip(leaves, grads)), opt_state, params)
            params = apply_updates(params, updates)
            losses.append(loss.detach())
        return params, opt_state, {"loss": torch.stack(losses).mean(dim=0)}

    return local_train


def _partition(ds, cfg: SimulationConfig):
    if cfg.distribution == "balanced_noniid":
        idx = partition_lib.balanced_noniid(ds.train_y, cfg.num_vehicles, seed=cfg.seed)
    elif cfg.distribution == "unbalanced_iid":
        sizes = (125, 375, 1125) if "cifar" in ds.name else (150, 450, 1350)
        idx = partition_lib.unbalanced_iid(len(ds.train_y), cfg.num_vehicles,
                                           size_choices=sizes, seed=cfg.seed)
    else:
        raise ValueError(cfg.distribution)
    return idx


def probe_d_max(cfg: SimulationConfig, net: topology_lib.RoadNetwork,
                chunk: int = 0) -> int:
    """The exact neighbour-slot demand of a run: replay the (deterministic,
    seeded) contact stream over the full horizon and return the largest
    contact-set size (incl. self) any participant ever sees.

    Mobility / drop streams are clones of the real run's, so an auto-probed
    ``D_max`` can never overflow. The replay is chunked so the transient
    probe buffer stays ~16 MB at any fleet size; for very long large-K runs
    pin ``cfg.d_max`` / ``cfg.contact_density`` instead to skip the probe.
    """
    mob = mobility_lib.make_mobility(
        cfg.mobility, net, mobility_lib.MobilityConfig(
            num_vehicles=cfg.num_vehicles, epoch_duration=cfg.epoch_duration,
            comm_range=cfg.comm_range, seed=cfg.seed))
    rsu_pos = (extensions_lib.place_rsus(net, cfg.num_rsus, seed=cfg.seed)
               if cfg.num_rsus else None)
    drop_rng = np.random.default_rng(cfg.seed + 7)
    if chunk <= 0:
        total = cfg.num_vehicles + cfg.num_rsus
        chunk = max(1, min(64, (16 << 20) // (4 * total * total)))
    d_max, remaining = 1, cfg.epochs
    while remaining > 0:
        t = min(chunk, remaining)
        remaining -= t
        dense = extensions_lib.contact_window(
            mob.advance_positions(t), rsu_pos, cfg.comm_range, cfg.p_drop,
            drop_rng)
        d_max = max(d_max, topology_lib.max_contact_degree(dense))
    return d_max


class ContactStream:
    """Host-side mobility -> batched contact windows (numpy).

    ``window(T)`` advances the mobility process T epochs and returns the
    window in the representation named by ``cfg.contact_format``
    (core.contacts registry): the dense [T, Ktot, Ktot] contact tensor, or
    ``SparseContacts`` neighbour lists [T, Ktot, D_max] built one epoch at a
    time (RSU columns appended, dropped edges removed in both). Both RNG
    streams (mobility, drops) advance one epoch at a time, so ``window(a);
    window(b)`` equals ``window(a + b)`` row for row, and sparse windows see
    the same dropped edges as dense ones.

    For the sparse format, ``d_max`` is resolved once at construction:
    ``cfg.d_max`` if pinned, else ``ceil(contact_density * Ktot)``, else the
    exact full-horizon probe (``probe_d_max``).

    ``timer`` spans the probe (``d_max_probe``) and each window
    (``contact_window``).
    """

    def __init__(self, cfg: SimulationConfig, net: topology_lib.RoadNetwork,
                 timer: PhaseTimer | None = None):
        self.cfg = cfg
        self.timer = timer
        self.mob = mobility_lib.make_mobility(
            cfg.mobility, net, mobility_lib.MobilityConfig(
                num_vehicles=cfg.num_vehicles, epoch_duration=cfg.epoch_duration,
                comm_range=cfg.comm_range, seed=cfg.seed))
        self.rsu_pos = (extensions_lib.place_rsus(net, cfg.num_rsus, seed=cfg.seed)
                        if cfg.num_rsus else None)
        self.drop_rng = np.random.default_rng(cfg.seed + 7)
        self.format = contacts_lib.get_contact_format(cfg.contact_format)
        self.d_max = self._resolve_d_max(net) if self.format.sparse else 0

    def _resolve_d_max(self, net: topology_lib.RoadNetwork) -> int:
        total = self.cfg.num_vehicles + self.cfg.num_rsus
        if self.cfg.d_max > 0:
            return min(self.cfg.d_max, total)
        if self.cfg.contact_density is not None:
            return max(1, min(total, int(np.ceil(
                self.cfg.contact_density * total))))
        with phase(self.timer, "d_max_probe"):
            return probe_d_max(self.cfg, net)

    def window(self, num_epochs: int):
        with phase(self.timer, "contact_window"):
            positions = self.mob.advance_positions(num_epochs)
            if self.format.sparse:
                idx, mask = extensions_lib.neighbour_window(
                    positions, self.rsu_pos, self.cfg.comm_range, self.cfg.p_drop,
                    self.drop_rng, self.d_max)
                return contacts_lib.SparseContacts(idx, mask)
            return extensions_lib.contact_window(
                positions, self.rsu_pos, self.cfg.comm_range, self.cfg.p_drop,
                self.drop_rng)


@dataclass
class EngineContext:
    """Everything one federation run needs, built once per (config, seed).

    ``round_fn(state, contacts, target, batch, generator, fed_data)`` applies
    one algorithm round; ``sample_fn(fed_data, generator)`` draws the
    per-epoch device-side batch; ``model_of(state)`` extracts the evaluable
    parameter stack. All three are the registered algorithm's hooks bound to
    this run's ``setup`` (fed.algorithms). ``init_rng`` is the run's
    ``torch.Generator`` on ``device`` (batches, dropout).

    A context with ``num_seeds = S > 0`` is S runs stacked on a leading seed
    axis (``stack_contexts``): ``init_rng`` is then a tuple of S generators
    and ``contacts`` the S runs' streams.
    """
    cfg: SimulationConfig
    device: torch.device
    total_nodes: int
    fed_data: pipeline.FederatedData
    target: Tensor
    local_mask: Tensor | None
    contacts: ContactStream
    init_state: Any
    init_rng: torch.Generator
    round_fn: Callable
    sample_fn: Callable
    model_of: Callable
    eval_fn: Callable
    algorithm: algorithms_lib.Algorithm
    setup: algorithms_lib.AlgorithmSetup
    execution_plan: dict | None = None
    final_state: Any = None     # the federation state a finished run left
    num_seeds: int = 0          # S of a seed-stacked context; 0 = one run

    @property
    def window_fn(self) -> Callable:
        return build_window_fn(self)

    def state_spec(self):
        """Which leaves of the run's state are row-sharded under the
        shard_map backend (the algorithm's ``state_spec``; under
        ``overlap="delayed"`` the stale params shard like the live ones)."""
        spec = self.algorithm.state_spec(self.setup)
        return (spec, vehicle_axis.ROW) if self.cfg.overlap == "delayed" else spec

    def bind(self, shard: vehicle_axis.VehicleSharding) -> "EngineContext":
        """Rebind the run to a vehicle-axis sharding regime
        (``core.vehicle_axis.VehicleSharding``): the gossip mix becomes the
        sharded partial product + reduce-scatter, the hooks slice
        per-vehicle rows to this shard, and the initial state keeps this
        shard's rows of every ``ROW`` leaf."""
        setup = replace(
            self.setup, shard=shard,
            mix_params_fn=vehicle_axis.sharded_mix(
                self.setup.mix_params_fn, shard, comm_bucket_mb=self.cfg.comm_bucket_mb,
                timer=self.setup.timer))
        algo = self.algorithm
        init_state = vehicle_axis.shard_state(self.state_spec(), self.init_state, shard)
        return replace(
            self, setup=setup,
            init_state=pytree.tree_map(torch.clone, init_state),
            round_fn=partial(algo.round, setup),
            sample_fn=partial(algo.sample, setup),
            model_of=partial(algo.model_of, setup))


def make_eval_fn(accuracy_fn, eval_x: Tensor, eval_y: Tensor):
    """Accuracy of every stacked model on the shared eval set -> ``[K]`` (one
    entry per row of the stack it is given: the whole federation, a shard's
    rows, or a folded seed stack). The eval set is walked in chunks of
    ``EVAL_CHUNK`` samples, each broadcast over the stacked models."""
    n = eval_x.shape[0]

    @torch.no_grad()
    def eval_fn(params_stack: dict) -> Tensor:
        rows = next(iter(params_stack.values())).shape[0]
        correct = torch.zeros(rows, dtype=torch.float32, device=eval_x.device)
        for s in range(0, n, EVAL_CHUNK):
            x = eval_x[s:s + EVAL_CHUNK]
            y = eval_y[s:s + EVAL_CHUNK]
            acc = accuracy_fn(params_stack, x.expand((rows,) + tuple(x.shape)),
                              y.expand(rows, -1))
            correct += acc * x.shape[0]
        return correct / max(n, 1)

    return eval_fn


def build_context(cfg: SimulationConfig, dataset=None, init_params: dict | None = None,
                  timer: PhaseTimer | None = None) -> EngineContext:
    """Shared setup of a run: data partition, mobility stream, model init —
    then the registered algorithm (``fed.algorithms``) supplies state init,
    round, sampling, and model extraction.

    ``init_params`` injects ONE vehicle's initial parameters (a dictionary of
    tensors or numpy arrays in the reference's names and layouts) in place
    of the seeded init — how a test starts both stacks from the same point.
    ``timer`` attaches per-phase timing (``profiling``): a span
    ``build_context`` around this set-up, the contact stream's spans
    (``ContactStream``) and the rounds' phases.

    ``execution="auto"`` configs are resolved here, before anything else
    (cost-model backend / format selection); the plan rides on
    ``ctx.execution_plan``.
    """
    with phase(timer, "build_context"):
        cfg, execution_plan = resolve_execution(cfg)
        device = resolve_device(cfg)
        from . import backends as backends_lib

        algo = algorithms_lib.get_algorithm(cfg.algorithm)   # both raise on what
        backends_lib.get_backend(cfg.backend)                # is not ported yet
        ds = dataset or data_lib.load_dataset(cfg.dataset, seed=cfg.seed)
        init_fn, loss_fn, accuracy_fn = cnn_lib.make_cnn_task(ds.name)

        idx = _partition(ds, cfg)
        # extension: RSUs are extra data-less participants appended after vehicles
        total_nodes = cfg.num_vehicles + cfg.num_rsus
        if cfg.num_rsus:
            idx = idx + [np.array([0])] * cfg.num_rsus  # dummy index, zero weight
        dense, counts = partition_lib.pad_to_uniform(idx, seed=cfg.seed)
        if cfg.num_rsus:
            counts = counts.copy()
            counts[cfg.num_vehicles:] = 0
        fed_data = pipeline.make_federated_data(ds.train_x, ds.train_y, dense,
                                                counts, device=device)
        target = state_vector.target_state(fed_data.counts)
        local_mask = (torch.as_tensor(extensions_lib.rsu_local_step_mask(
            cfg.num_vehicles, cfg.num_rsus), device=device) if cfg.num_rsus else None)

        net = topology_lib.make_road_network(cfg.road_net, seed=cfg.seed)
        contacts = ContactStream(cfg, net, timer=timer)

        # identical random init on every vehicle (paper Alg. 1 line 1); drawn on
        # the host so a seed gives the same model on either device
        if init_params is None:
            init_params = init_fn(torch.Generator().manual_seed(cfg.seed))
        params_stack = {
            name: p.expand((total_nodes,) + tuple(p.shape)).clone()
            for name, p in convert.params_from_numpy(init_params, device).items()}
        rng = torch.Generator(device=device).manual_seed(cfg.seed)

        optimizer = sgd(cfg.lr)
        local_train_fn = make_local_train_fn(loss_fn, optimizer)
        opt_stack = optimizer.init(params_stack, num_stacked=total_nodes)

        eval_x = torch.as_tensor(ds.test_x[: cfg.eval_samples], device=device)
        eval_y = torch.as_tensor(ds.test_y[: cfg.eval_samples], device=device).long()
        eval_fn = make_eval_fn(accuracy_fn, eval_x, eval_y)

        setup = algorithms_lib.AlgorithmSetup(
            cfg=cfg, total_nodes=total_nodes, loss_fn=loss_fn,
            local_train_fn=local_train_fn, params_stack=params_stack,
            opt_stack=opt_stack, local_mask=local_mask,
            mix_params_fn=resolve_mix_params_fn(cfg), timer=timer)

        init_state = algo.init_state(setup)
        if cfg.overlap == "delayed":
            # the double buffer: the params each vehicle last put on the air.
            # Round 0 mixes the identical broadcast init — what a real fleet's
            # first in-flight exchange would carry. Carried through the windows,
            # so trajectories stay window-chunk-invariant.
            init_state = (init_state, params_stack)

        return EngineContext(
            cfg=cfg, device=device, total_nodes=total_nodes, fed_data=fed_data,
            target=target, local_mask=local_mask, contacts=contacts,
            init_state=init_state, init_rng=rng,
            round_fn=partial(algo.round, setup),
            sample_fn=partial(algo.sample, setup),
            model_of=partial(algo.model_of, setup),
            eval_fn=eval_fn, algorithm=algo, setup=setup,
            execution_plan=execution_plan)


def build_window_fn(ctx: EngineContext) -> Callable:
    """The window: loop the algorithm round over the window's contact graphs
    — dense [T, K, K] matrices or [T, K, D_max] neighbour lists, already on
    the run's device.

    Returns ``window(state, rng, fed_data, target, contacts, eval_mask) ->
    (state, rng, traj)`` where ``traj`` stacks per-epoch diagnostics;
    accuracy / consensus rows are NaN on epochs the (host-side) mask skips.
    Nothing in the loop reads a device value back, so the host runs ahead of
    the device for the whole window.

    Under ``overlap="delayed"`` the state is ``(algorithm state, stale
    params)``. On a seed-stacked context (``num_seeds > 0``) the contacts are
    ``[S, T, ...]`` and every per-epoch row carries the seed axis first. On a
    context bound to a shard (``EngineContext.bind``) the state holds this
    shard's rows; consensus and the loss are completed over the group and the
    window's accuracy rows are all-gathered to ``[T, K]`` on every shard.
    """
    round_fn, sample_fn = ctx.round_fn, ctx.sample_fn
    model_of, eval_fn = ctx.model_of, ctx.eval_fn
    payload_mb = exchange_payload_mb(ctx)
    device, timer = ctx.device, ctx.setup.timer
    shard = ctx.setup.shard
    rows_here = vehicle_axis.local_nodes(ctx.total_nodes, shard)
    seeded = ctx.num_seeds > 0
    lead = (ctx.num_seeds,) if seeded else ()
    # per-seed means on a seed-stacked context, the whole mean otherwise
    mean = partial(torch.mean, dim=-1) if seeded else torch.mean
    delayed = ctx.cfg.overlap == "delayed"
    if delayed:
        algo, setup = ctx.algorithm, ctx.setup
        delayed_mix = vehicle_axis.delayed_gossip_mix(setup.mix_params_fn, shard)

    def delayed_round(st, contacts_t, target, batch, generator, fed_data):
        """One round under overlap="delayed": the algorithm's mix call is
        rerouted through the stale buffer, and whatever the algorithm put on
        the air this round (its mix input) becomes the next buffer —
        algorithm-agnostic, whether it mixes before training (dds/dfl/d_sgd),
        after (d_fedavg), or a bias-corrected stack (sp)."""
        algo_st, stale = st
        sent = {}

        def mix(mixing, params):
            sent["payload"] = params
            return delayed_mix(mixing, params, stale)

        algo_st, diags = algo.round(replace(setup, mix_params_fn=mix), algo_st,
                                    contacts_t, target, batch, generator,
                                    fed_data)
        return (algo_st, sent.get("payload", stale)), diags

    def evaluate(st):
        model = model_of(st)
        consensus = aggregation.consensus_distance(model, seed_axis=seeded, shard=shard)
        return eval_fn(model), consensus.to(torch.float32)

    def skip():
        return (torch.full(lead + (rows_here,), float("nan"),
                           dtype=torch.float32, device=device),
                torch.full(lead, float("nan"), dtype=torch.float32, device=device))

    def window(state, rng, fed_data, target, contacts, eval_mask):
        rows = []
        step = delayed_round if delayed else round_fn
        for t, do_eval in enumerate(np.asarray(eval_mask)):
            contacts_t = contacts_lib.epoch_of(contacts, t, axis=1 if seeded else 0)
            with phase(timer, "sample"):
                batch = sample_fn(fed_data, rng)
            state, diags = step(state, contacts_t, target, batch, rng, fed_data)
            algo_state = state[0] if delayed else state
            with phase(timer, "eval"):
                accs, consensus = evaluate(algo_state) if do_eval else skip()
            # directed V2V exchanges this round: contact edges minus the
            # always-on self loops (the dense matrix and the neighbour list
            # count identically)
            edges = contacts_lib.count_edges(contacts_t)
            rows.append({
                "accuracy": accs,
                "consensus": consensus,
                "entropy": diags["entropy"],
                "kl_divergence": diags["kl_divergence"],
                "kl_mean": mean(diags["kl_divergence"]),
                "comm_mb": edges.to(torch.float32) * payload_mb,
                # per-shard mean of equal row counts -> pmean == global mean
                "loss": shard.pmean(mean(diags["loss"])),
            })
        traj = {name: torch.stack([r[name] for r in rows]) for name in rows[0]}
        traj["accuracy"] = shard.gather_rows(traj["accuracy"], dim=-1)
        return state, rng, traj

    return window


def _stack(trees: list):
    """Stack a list of equally shaped trees (tensors in dictionaries and
    (named) tuples) on a new leading axis."""
    leaves, spec = zip(*(pytree.tree_flatten(t) for t in trees))
    return pytree.tree_unflatten(
        [torch.stack(column) for column in zip(*leaves)], spec[0])


def _fold(tree):
    """``[S, K, ...]`` -> ``[S * K, ...]`` on every tensor of a tree."""
    return pytree.tree_map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), tree)


def _unfold(tree, seeds: int):
    """``[S * K, ...]`` -> ``[S, K, ...]`` on every tensor of a tree."""
    return pytree.tree_map(
        lambda t: t.reshape((seeds, -1) + tuple(t.shape[1:])), tree)


def stack_contexts(ctxs: list[EngineContext], dataset) -> EngineContext:
    """S single-run contexts (one per seed, one shared dataset) as ONE
    context with a leading seed axis — the port's counterpart of the
    reference's ``jax.vmap`` of the window over seeds.

    States, targets, RSU masks and the stacked index tables
    (``pipeline.stack_federated_data``) carry the seed axis; the rounds take
    it as ``core`` writes it out, so each gossip-mix kernel launches once per
    round for every seed. Local training, the loss and the evaluation run on
    the folded ``[S * K]`` stack of the CNN. Each seed draws its picks and
    dropout masks from its own generator, in the order a single run of that
    seed draws them.
    """
    first = ctxs[0]
    seeds = len(ctxs)
    setup = first.setup
    base_loss, base_train = setup.loss_fn, setup.local_train_fn

    def loss_fn(params, x, y, generator=None):
        return base_loss(_fold(params), _fold(x), _fold(y),
                         generator).reshape(seeds, -1)

    def local_train_fn(params, opt_state, batch, generator):
        out = base_train(_fold(params), _fold(opt_state), _fold(batch), generator)
        return _unfold(out, seeds)

    local_mask = (None if first.local_mask is None
                  else torch.stack([c.local_mask for c in ctxs]))
    seed_setup = replace(
        setup, params_stack=_stack([c.setup.params_stack for c in ctxs]),
        opt_stack=_stack([c.setup.opt_stack for c in ctxs]),
        local_mask=local_mask, loss_fn=loss_fn, local_train_fn=local_train_fn)
    fed_stack = pipeline.stack_federated_data([c.fed_data for c in ctxs],
                                              seed=first.cfg.seed)
    algo = first.algorithm

    def sample_fn(fed_data, generators):
        return _stack([algo.sample(setup, pipeline.seed_view(fed_data, s), g)
                       for s, g in enumerate(generators)])

    _, _, accuracy_fn = cnn_lib.make_cnn_task(dataset.name)
    eval_x = torch.as_tensor(dataset.test_x[: first.cfg.eval_samples],
                             device=first.device)
    eval_y = torch.as_tensor(dataset.test_y[: first.cfg.eval_samples],
                             device=first.device).long()
    folded_eval = make_eval_fn(accuracy_fn, eval_x, eval_y)

    def eval_fn(params_stack):
        return folded_eval(_fold(params_stack)).reshape(seeds, -1)

    return replace(
        first, fed_data=fed_stack, target=torch.stack([c.target for c in ctxs]),
        local_mask=local_mask, contacts=[c.contacts for c in ctxs],
        init_state=_stack([c.init_state for c in ctxs]),
        init_rng=tuple(c.init_rng for c in ctxs),
        round_fn=partial(algo.round, seed_setup), sample_fn=sample_fn,
        model_of=partial(algo.model_of, seed_setup), eval_fn=eval_fn,
        setup=seed_setup, num_seeds=seeds)


def _default_window(cfg: SimulationConfig, progress: bool) -> int:
    """Resolve the window length. With ``window_size = 0`` the whole run is
    one window — except under ``progress``, where windows align to the eval
    cadence so progress lines stream (trajectories are chunk-invariant)."""
    if cfg.window_size > 0:
        return cfg.window_size
    if progress:
        return max(cfg.eval_every, 1)
    return max(cfg.epochs, 1)


def _eval_mask(cfg: SimulationConfig, start: int, length: int) -> np.ndarray:
    """Host-side eval schedule for window epochs [start, start + length)."""
    epochs = start + np.arange(length)
    return ((epochs + 1) % cfg.eval_every == 0) | (epochs == cfg.epochs - 1)


def _append_window(result: SimulationResult, traj, mask: np.ndarray, start: int,
                   num_vehicles: int, progress: bool) -> None:
    traj = {name: v.detach().cpu().numpy() for name, v in traj.items()}
    acc, ent, kl = traj["accuracy"], traj["entropy"], traj["kl_divergence"]
    consensus = traj["consensus"]
    # full per-epoch traces (no eval mask): diversity + communication volume
    result.kl_trace.extend(float(v) for v in traj["kl_mean"])
    result.comm_mb.extend(float(v) for v in traj["comm_mb"])
    for i in np.nonzero(mask)[0]:
        accs = acc[i, :num_vehicles]
        result.epochs_evaluated.append(start + int(i) + 1)
        result.avg_accuracy.append(float(accs.mean()))
        result.vehicle_accuracy.append(accs)
        result.entropy.append(ent[i])
        result.kl_divergence.append(kl[i])
        result.consensus_distance.append(float(consensus[i]))
        if progress:
            print(f"  epoch {start + int(i) + 1:4d}  avg_acc={accs.mean():.4f}  "
                  f"min={accs.min():.4f}  max={accs.max():.4f}", flush=True)


def run_with_context(ctx: EngineContext, progress: bool = False) -> SimulationResult:
    """Drive one federation through the engine on the execution backend
    named by ``cfg.backend`` (fed.backends registry)."""
    from . import backends as backends_lib

    with full_f32_matmul():
        return backends_lib.get_backend(ctx.cfg.backend).run(ctx, progress=progress)


def run(cfg: SimulationConfig, dataset=None, progress: bool = False) -> SimulationResult:
    """Build a context and run it through the engine."""
    return run_with_context(build_context(cfg, dataset=dataset), progress=progress)


def run_seeds(cfg: SimulationConfig, seeds, dataset=None, progress: bool = False,
              timer: PhaseTimer | None = None) -> list[SimulationResult]:
    """Run S independent federations (seeded partitions, mobility traces and
    inits) on the execution backend named by ``cfg.backend`` — one window
    loop over the seed-stacked state on the vmap backend.

    The dataset is shared across seeds (loaded once from ``cfg`` when not
    given). Returns one ``SimulationResult`` per seed, in ``seeds`` order.
    The batch's wall time is the caller's to record (the sweep runner keeps
    it per scenario): all seeds run as one loop, so per-seed ``wall_time``
    stays 0, as in the reference. ``timer`` goes to each seed's
    ``build_context``, and so to the seeds' contact streams and the rounds.

    ``execution="auto"`` is resolved HERE, before backend dispatch — the
    backend name itself is one of the knobs the cost model picks — and the
    plan is stamped on every result.
    """
    from . import backends as backends_lib

    cfg, plan = resolve_execution(cfg)
    with full_f32_matmul():
        results = backends_lib.get_backend(cfg.backend).run_seeds(
            cfg, seeds, dataset=dataset, progress=progress, timer=timer)
    if plan is not None:
        for r in results:
            r.execution_plan = plan
    return results
