"""Multi-pod dry run: one step of every (architecture x input shape) on the
production meshes, with 256 (512) ranks of a ``fake`` process group in one
process and every tensor on the ``meta`` device. It shows that the sharding
specs are coherent without hardware, and emits flops, HBM traffic, collective
bytes and memory per device for the roofline (``roofline.analysis``).

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each pair
with XLA and parses the partitioned HLO. Here nothing is lowered: the step
runs once, as rank 0, on DTensors placed by its specs
(``launch.sharding.placements``), and one dispatch mode counts what reaches
it. The mode lets every DTensor op through (it returns ``NotImplemented``), so
it sees the ops DTensor runs on rank 0's local shards and the collectives its
redistributions issue, and counts:

* flops — ``torch.utils.flop_counter``'s formulas on the local shapes
  (``FlopCounterMode`` itself sees DTensor ops at their global shapes);
* traffic — ``roofline.flop_cost.TrafficMode``'s definition (operand plus
  result bytes, views excluded) on local bytes;
* collective bytes — the result bytes of every ``_c10d_functional`` / ``c10d``
  collective, by the reference's kind names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``; the port issues no
  ``collective-permute``). The gossip mix is the port's ``sharded_mix``: a
  reduce-scatter per leaf;
* memory — argument and output bytes per rank (``memory_analysis``), from the
  placed tensors. Temporaries are not measured on meta tensors, so there is
  no ``temp_size_in_bytes``.

The step runs on ``meta`` tensors rather than under ``FakeTensorMode``:
DTensor's sharding propagation computes some shard offsets with tensors of
its own (``.tolist()``), which an ambient fake mode turns into fake tensors
that cannot be read. The record replaces the reference's ``lower_s`` /
``compile_s`` with ``run_s`` (the pair's wall time) and adds ``dtype``. The
reference's ``--lower-only`` and ``--dump-hlo`` have no meaning here (nothing
is lowered, there is no HLO). The dry run launches no CUDA kernel: the
baseline runs the plain path (``mix_params_fn=aggregation.mix_params``, the
reference's default); a kernel's wrapper reached on meta tensors fails the
pair. The ragged MoE (``ragged_moe``, ``opt_ragged``) steps through its
grouped products as the custom ops ``repro_torch::grouped_mm`` /
``grouped_mm_wgrad``: their fake implementations give the shapes on meta
tensors, their flop formulas 2·M·K·N per product, and their traffic is
counted as any op's (operand plus result bytes, the whole expert stack).

Importing this module brings up no process group and does not initialise
CUDA: ``dryrun_pair`` brings up a fake group of its own when none is up, and
tears it down.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out records.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ArchConfig
from ..configs.registry import ARCHITECTURES, get_config
from ..models import transformer
from ..models.layers import is_dtensor
from ..roofline.flop_cost import _tensor_bytes
from . import mesh as mesh_lib
from . import shapes as shapes_lib
from . import sharding as shard_lib
from . import steps as steps_lib

META = torch.device("meta")

# op name -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d"):
        return None
    return _KINDS.get(func._overloadpacket.__name__)


def _is_wrapper(func) -> bool:
    """A functional collective's wait or autograd wrapper: it hands on the
    collective's result and moves nothing."""
    return (func.namespace == "_c10d_functional"
            and func._overloadpacket.__name__ in ("wait_tensor", "_wrap_tensor_autograd"))


def _local_bytes(tree) -> int:
    """Bytes this rank holds of every tensor of ``tree`` (a DTensor's local
    shard; a plain tensor whole, as every rank holds it)."""
    return _tensor_bytes(pytree.tree_map(
        lambda x: x.to_local() if is_dtensor(x) else x, tree))


class DeviceCounter(TorchDispatchMode):
    """Per-device work of what runs under it, on DTensors or plain tensors:
    DTensor ops pass through (``NotImplemented``) and come back as rank 0's
    local ops, which are counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.traffic_bytes = 0
        self.collective_bytes: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = pytree.tree_leaves((args, kwargs))
        if any(is_dtensor(x) for x in leaves):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(x, FakeTensor) for x in leaves + pytree.tree_leaves(out)):
            # DTensor's sharding propagation, under a fake mode of its own,
            # making its fake arguments (``empty_strided``, which has no
            # tensor operand) and running the op on them at its global shapes
            # to learn its output's: no work of the step
            return out
        kind = _collective_kind(func)
        if kind is not None:
            # the collective's result: a functional op returns it, a c10d op
            # writes its first argument
            result = out if func.namespace == "_c10d_functional" else args[0]
            self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                           + _tensor_bytes(result))
        elif func._overloadpacket in self._formulas:
            self.flops += self._formulas[func._overloadpacket](*args, **kwargs, out_val=out)
        if not func.is_view and not _is_wrapper(func):
            self.traffic_bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


# ------------------------------------------------------------- the pair -----

def _fake_group(world_size: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _train_args(cfg: ArchConfig, shape, mesh, ts) -> list:
    num_v = mesh_lib.total_devices(mesh) // (mesh_lib._shape(mesh)["fsdp"]
                                             * mesh_lib._shape(mesh)["model"])
    params, opt, sm = steps_lib.train_state_specs(cfg, num_v)
    ins = shapes_lib.train_input_specs(cfg, shape, num_v)
    args = [params, opt, sm, ins["tokens"], ins["contact"], ins["target"]]
    if cfg.embed_input:
        args.append(ins["prefix_embeds"])
    return args


def run_pair(mesh, arch: str, shape, cfg: ArchConfig, *, multi_pod: bool = False,
             variant: str = "baseline", step_overrides: dict | None = None) -> dict:
    """One step of ``cfg`` at ``shape`` (an ``InputShape``) on ``mesh`` (a
    federation mesh for a train shape, a ``data`` x ``model`` mesh for
    serving), as rank 0 of the group that is up. ``cfg`` is the unpadded
    config; it is padded for the mesh here, as the reference does. Returns
    the record."""
    from ..core import aggregation
    from .variants import apply_variant

    t0 = time.perf_counter()
    if shape.kind == "train":
        cfg = cfg.pad_for_mesh(16)
        cfg, overrides = apply_variant(variant, cfg, shape.kind)
        overrides.setdefault("mix_params_fn", aggregation.mix_params)
        overrides.update(step_overrides or {})
        step = steps_lib.build_dds_train_step(cfg, mesh=mesh, **overrides)
        args = _train_args(cfg, shape, mesh, step)
    else:
        cfg = shapes_lib.serve_cfg(cfg)
        if shape.name == "long_500k":
            cfg = shapes_lib.long_context_cfg(cfg)
        cfg, overrides = apply_variant(variant, cfg, shape.kind)
        overrides.update(step_overrides or {})
        params = transformer.init_params(torch.Generator(), cfg, device=META)
        if shape.kind == "prefill":
            allowed = {k: v for k, v in overrides.items() if k in ("attn_impl", "window")}
            step = steps_lib.build_prefill_step(cfg, mesh=mesh, **allowed)
            ins = shapes_lib.prefill_input_specs(cfg, shape)
            args = [params, ins["tokens"]]
            if cfg.embed_input:
                args.append(ins["prefix_embeds"])
        else:
            allowed = {k: v for k, v in overrides.items() if k == "replicate_batch"}
            allowed.setdefault("replicate_batch", shape.global_batch < 16)
            step = steps_lib.build_decode_step(cfg, mesh=mesh, **allowed)
            ins = shapes_lib.decode_input_specs(cfg, shape)
            args = [params, ins["tokens"], ins["state"]]
    args = [shard_lib.place_tree(x, mesh, spec) for x, spec in zip(args, step.in_specs)]
    counter = DeviceCounter()
    with counter:
        out = step.fn(*args)
    compute = overrides.get("compute_dtype")
    return {
        "arch": arch, "shape": shape.name, "multi_pod": multi_pod,
        "mesh": mesh_lib._shape(mesh), "variant": variant,
        "dtype": str(compute or torch.float32).replace("torch.", ""),
        "run_s": time.perf_counter() - t0,
        "flops_per_device": float(counter.flops),
        "traffic_bytes_per_device": float(counter.traffic_bytes),
        "collective_bytes_per_device": {k: float(v)
                                        for k, v in counter.collective_bytes.items()},
        "memory_analysis": {"argument_size_in_bytes": _local_bytes(args),
                            "output_size_in_bytes": _local_bytes(out)},
    }


def dryrun_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
                variant: str = "baseline", step_overrides: dict | None = None) -> dict:
    """One (arch x shape) on the production meshes: a ``fake`` group of 256
    ranks (512 with ``multi_pod``) brought up unless one is, and torn down
    (with the meshes made on it) if it was brought up here."""
    shape = shapes_lib.INPUT_SHAPES[shape_name]
    own = not dist.is_initialized()
    if own:
        _fake_group(512 if multi_pod else 256)
    try:
        if shape.kind == "train":
            vehicle, fsdp = shapes_lib.FED_LAYOUT[arch]
            mesh = mesh_lib.make_federation_mesh(multi_pod=multi_pod, vehicle=vehicle,
                                                 fsdp=fsdp)
        else:
            mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        return run_pair(mesh, arch, shape, get_config(arch), multi_pod=multi_pod,
                        variant=variant, step_overrides=step_overrides)
    finally:
        if own:
            mesh_lib.shutdown()


def error_record(arch: str, shape_name: str, multi_pod: bool, exc: BaseException) -> dict:
    """The record of a failed pair: the exception and the innermost line of
    the port that raised it."""
    where = [f"{os.path.relpath(f.filename, os.path.dirname(os.path.dirname(__file__)))}"
             f":{f.lineno}" for f in traceback.extract_tb(exc.__traceback__)
             if f"{os.sep}repro_torch{os.sep}" in f.filename]
    at = f" (at {where[-1]})" if where else ""
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "error": f"{type(exc).__name__}: {exc}{at}"}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Dry run of the port's steps on a fake 256 / 512-rank group "
                    "(meta tensors; no card needed).")
    ap.add_argument("--arch", choices=sorted(ARCHITECTURES), default=None)
    ap.add_argument("--shape", choices=sorted(shapes_lib.INPUT_SHAPES), default=None,
                    nargs="+", help="one or more shapes of --arch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCHITECTURES for s in shapes_lib.INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, s) for s in args.shape]
    else:
        ap.error("--arch and --shape required unless --all")

    failures = 0
    for arch, shape in pairs:
        tag = f"{arch} x {shape} ({'2x16x16' if args.multi_pod else '16x16'})"
        try:
            res = dryrun_pair(arch, shape, multi_pod=args.multi_pod, variant=args.variant)
            print(f"[OK] {tag}: flops/dev={res['flops_per_device']:.3e} "
                  f"traffic/dev={res['traffic_bytes_per_device']:.3e}B "
                  f"coll/dev={sum(res['collective_bytes_per_device'].values()):.3e}B "
                  f"{res['collective_bytes_per_device']} run={res['run_s']:.1f}s", flush=True)
            print("     memory:", res["memory_analysis"], flush=True)
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            failures += 1
            res = error_record(arch, shape, args.multi_pod, e)
            res["variant"] = args.variant
            print(f"[FAIL] {tag}: {res['error']}", flush=True)
            traceback.print_exc()
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
