"""Process groups and device meshes for the vehicle-sharded federation.

Counterpart of ``repro.launch.mesh`` on ``torch.distributed``. Where the
reference runs one SPMD program over a ``jax`` device mesh, the port runs
one process per shard:

* ``initialize_multihost`` brings up the default process group — from its
  arguments, or from the environment ``torchrun`` sets — and records the
  transport the caller chose. With one process it is a no-op returning 1.
* ``make_federation_mesh`` / ``make_multihost_federation_mesh`` arrange the
  ranks as a ``DeviceMesh`` with dims ``("vehicle", "fsdp", "model")``; the
  vehicle group of the shard_map backend is ``mesh.get_group("vehicle")``.
* ``make_production_mesh`` keeps the reference's 16 x 16 ``data`` x
  ``model`` shape (2 x 16 x 16 with ``pod``): it needs 256 (512) ranks.

**The transport is the caller's choice, never picked on its own:**

* ``"nccl"`` (the default) — each rank owns its own card ``cuda:{local
  rank}``; asking for it where ranks would share a card raises;
* ``"gloo"`` — every rank on the CPU;
* ``"gloo_staged"`` — gloo with the collectives' tensors staged through host
  memory, for several ranks on one card (a smoke run on one GPU; it runs the
  sharded path, it does not measure a multi-card one).
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "gloo_staged")

# the transport initialize_multihost brought the default group up with
_TRANSPORT: dict[str, str] = {}
_MESHES: dict[tuple, object] = {}


def check_transport(transport: str, device: str | torch.device) -> None:
    """Raise unless ``transport`` can carry collectives of tensors on
    ``device`` (the run's ``SimulationConfig.device``)."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} ({'|'.join(TRANSPORTS)})")
    on_card = torch.device(device).type == "cuda"
    if transport == "gloo" and on_card:
        raise ValueError("transport 'gloo' carries CPU tensors; for ranks on a card "
                         "pass 'nccl' (a card per rank) or 'gloo_staged' (shared card)")
    if transport != "gloo" and not on_card:
        raise ValueError(f"transport {transport!r} carries tensors on a card; for a "
                         "CPU run pass transport='gloo'")


def check_nccl_cards(local_rank: int, local_world_size: int, device_count: int) -> None:
    """NCCL needs a card per rank: raise where the ranks of this host
    (``local_world_size``) outnumber its cards, so that a card would be held
    by two ranks."""
    if local_world_size > device_count or not 0 <= local_rank < device_count:
        raise ValueError(
            f"transport 'nccl' needs one card per rank: {local_world_size} ranks on "
            f"this host share {device_count} card(s) (local rank {local_rank}); "
            "launch at most one rank per card, or pass transport='gloo_staged'")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def initialize_multihost(*, coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         transport: str = "nccl",
                         init_method: str | None = None,
                         timeout_s: float | None = None) -> int:
    """Bring up the default process group for a vehicle-sharded run.

    ``num_processes`` / ``process_id`` default to the environment
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``; NCCL also reads
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, defaulting to the rank and the
    world size: one host). The
    rendezvous is ``init_method`` if given (``"file:///path"``,
    ``"tcp://host:port"``), else ``tcp://{coordinator_address}``, else the
    environment (``MASTER_ADDR`` / ``MASTER_PORT``). With NCCL the rank
    takes the card ``cuda:{local_rank}`` as its current device.
    ``timeout_s`` bounds how long a collective waits for the other ranks
    (torch.distributed's default when None).

    With one process and no ``init_method``: a no-op returning 1 (the
    single-process fallback: the shard_map backend then runs the global
    path). An ``init_method`` brings a group up for one process too (a mesh of
    one rank, for the mesh-aware steps of ``launch.steps``). Otherwise returns
    the world size. Calling it again once the group is up returns its size.
    """
    num_processes = _env_int("WORLD_SIZE", 1) if num_processes is None else num_processes
    if num_processes <= 1 and init_method is None:
        return 1
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} ({'|'.join(TRANSPORTS)})")
    if dist.is_initialized():
        if _TRANSPORT.get("default") != transport:
            raise RuntimeError(f"the process group is already up with transport "
                               f"{_TRANSPORT.get('default')!r}, not {transport!r}")
        return dist.get_world_size()
    process_id = _env_int("RANK", 0) if process_id is None else process_id
    if transport == "nccl":
        local_rank = _env_int("LOCAL_RANK", process_id)
        local_world_size = _env_int("LOCAL_WORLD_SIZE", num_processes)
        if not torch.cuda.is_available():
            raise RuntimeError("transport 'nccl' needs a CUDA device; none is available")
        check_nccl_cards(local_rank, local_world_size, torch.cuda.device_count())
        torch.cuda.set_device(local_rank)
    if init_method is None:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    extra = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group("nccl" if transport == "nccl" else "gloo",
                            init_method=init_method, world_size=num_processes,
                            rank=process_id, **extra)
    _TRANSPORT["default"] = transport
    return dist.get_world_size()


def transport() -> str | None:
    """The transport ``initialize_multihost`` brought the group up with
    (None before it did)."""
    return _TRANSPORT.get("default")


def shutdown() -> None:
    """Tear the default process group down, and forget its meshes and the
    DTensor plans made on them."""
    _MESHES.clear()
    _TRANSPORT.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    _forget_dtensor_plans()


def _forget_dtensor_plans() -> None:
    """DTensor caches its sharding decisions and redistribution plans by
    placements and mesh shape, not by process group, and a plan may hold a
    mesh of its own: after the group is destroyed, a later group's DTensors of
    the same shapes would reuse a plan naming the dead group's subgroups.
    Clear those caches (each where this torch has it)."""
    import sys

    dt = sys.modules.get("torch.distributed.tensor")
    if dt is None:                      # no DTensor made in this process
        return
    prop = dt.DTensor._op_dispatcher.sharding_propagator
    redistribute = sys.modules.get("torch.distributed.tensor._redistribute")
    for cached in (getattr(prop, "propagate_op_sharding", None),
                   getattr(prop, "_propagate_tensor_meta_cached", None),
                   getattr(redistribute, "_gen_transform_infos", None)):
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()
    for clear in (getattr(redistribute, "clear_redistribute_planner_cache", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)):
        if clear is not None:
            clear()


def world_size() -> int:
    """Ranks of the default process group; 1 when none is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_rank_zero() -> bool:
    """True on rank 0 of the default group, and when no group is up: the
    process that prints summaries and writes stores."""
    return world_size() == 1 or dist.get_rank() == 0


def _device_type() -> str:
    return "cuda" if transport() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple):
    """The mesh of this shape over the default group, made once per group: a
    mesh cached under a group since destroyed is made anew."""
    from torch.distributed.device_mesh import init_device_mesh

    key = (shape, names)
    group = dist.group.WORLD if dist.is_initialized() else None
    if key not in _MESHES or _MESHES[key][0] is not group:
        _MESHES[key] = (group, init_device_mesh(_device_type(), shape, mesh_dim_names=names))
    return _MESHES[key][1]


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ``data`` x ``model``, or
    (2, 16, 16) ``pod`` x ``data`` x ``model`` — one rank per device, so it
    needs 256 (512) ranks and raises with fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; "
                         f"{world_size()} are up")
    return _mesh(shape, names)


def make_federation_mesh(*, multi_pod: bool = False, vehicle: int = 16,
                         fsdp: int = 1, model: int = 16, explicit: bool = False):
    """Mesh (pod?, vehicle, fsdp, model) for DFL training.

    Production form (``explicit=False``): the production ranks reshaped —
    vehicle * fsdp must equal the production data axis (16) and the model
    axis is the production 16.

    Explicit form: the group's ranks, in order, reshaped to (vehicle, fsdp,
    model) — how the shard_map backend builds its vehicle mesh on whatever
    ranks are up. ``multi_pod`` applies to the production form only.
    """
    if explicit:
        if world_size() != vehicle * fsdp * model:
            raise ValueError(f"{world_size()} ranks cannot fill a ({vehicle}, {fsdp}, "
                             f"{model}) federation mesh")
        return _mesh((vehicle, fsdp, model), ("vehicle", "fsdp", "model"))
    if model != 16:
        raise ValueError("the production federation mesh has a fixed model axis of 16; "
                         "pass explicit=True to change it")
    if vehicle * fsdp != 16:
        raise ValueError(f"vehicle({vehicle}) * fsdp({fsdp}) must be 16")
    make_production_mesh(multi_pod=multi_pod)            # checks the rank count
    if multi_pod:
        return _mesh((2, vehicle, fsdp, 16), ("pod", "vehicle", "fsdp", "model"))
    return _mesh((vehicle, fsdp, 16), ("vehicle", "fsdp", "model"))


def make_multihost_federation_mesh(*, vehicle: int | None = None, fsdp: int = 1,
                                   model: int = 1):
    """Federation mesh over every rank of the default group (after
    ``initialize_multihost``). ``vehicle`` defaults to every rank not taken
    by the fsdp / model dims; dim names match ``make_federation_mesh``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is up: call initialize_multihost first")
    if vehicle is None:
        vehicle = world_size() // (fsdp * model)
    return make_federation_mesh(vehicle=vehicle, fsdp=fsdp, model=model, explicit=True)


def vehicle_axes(mesh) -> tuple[str, ...]:
    """Mesh dims the federation vehicle axis is sharded over."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "vehicle")
    return ("vehicle",)


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh dims a serving batch dim is sharded over."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def _shape(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def num_vehicles(mesh, *, per_pod_vehicle: int) -> int:
    return _shape(mesh).get("pod", 1) * per_pod_vehicle


def total_devices(mesh) -> int:
    return int(math.prod(_shape(mesh).values()))
