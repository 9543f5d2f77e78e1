"""The DFL-DDS training round over a stack of vehicle transformers, and the
serving steps (prefill / decode).

Counterpart of ``repro.launch.steps``. Each step carries its sharding specs
(``launch.sharding.P`` trees, in the order of its arguments and results, as
the reference's); ``named(mesh, specs)`` turns them into DTensor placements
and ``train_state_specs`` gives the train state's shapes on ``meta``.

One round (``build_dds_train_step``), for V vehicles whose parameters are
stacked on a leading ``[V]`` axis of every leaf (the layout of
``init_train_state`` and ``convert.train_state_from_numpy``):

  P1 (aggregation weights from the state vectors) -> the gossip mix of the
  whole stack -> E local AdamW steps per vehicle on its tokens -> the state
  vectors' update (Eqs. 5-7).

Memory decides its shape at full width. The default mix
(``kernels.gossip_mix.ops.mix_params_cuda_``) writes the mixed stack into the
parameter leaves themselves: no second copy of the stack and no copy back. It
does so on the card where ``gossip_mix_matmul`` mixes V x V in place (its
column mapping, ``kernel.matmul_path``: V <= 16) and always on the CPU. Past
that limit the round takes the functional ``mix_params_cuda`` (the kernel's
tile mapping), as it does a ``mix_params_fn`` passed by the caller: the output
is copied back into the leaves and freed. Each vehicle then trains on views of
its row of every leaf (detached, ``requires_grad_``, ``torch.autograd.grad``
of ``lm_loss``), and the AdamW update is applied one leaf at a time, written
in place into that row of the parameters and of the moments, each gradient
freed as soon as it is used. So the step updates ``params`` and ``opt_state``
in place, and returns them. In model copies for V vehicles (f32, one copy is
7.57 GiB at qwen3-1.7b's width): 3V at the mix (parameters V, AdamW moments
2V; 4V with a functional mix), 3V + 1 (one vehicle's gradients) plus the
loss's activations and one leaf's temporaries during local training. At V=2
that is 6 copies (45.4 GiB) at the mix and 7 (53.0 GiB) plus activations in
training, where a functional mix peaks at 8 (60.6 GiB); a whole-tree
functional AdamW update of one vehicle would hold three more copies of a
model. The loop over vehicles is the port's counterpart of the reference's
``vmap``, as the loop over layers is of its ``lax.scan``. The reference splits
an ``rng`` per vehicle and uses none of it (no dropout), so the port's step
takes none.

**On a mesh** (``mesh=`` a ``launch.mesh`` federation mesh, dims ``vehicle``
/ ``fsdp`` / ``model``, ``pod`` first when multi-pod) the round runs once per
rank, on DTensors placed by ``in_specs`` (``convert.place_train_state``). The
gossip mix is linear over vehicles and element-wise over parameter columns,
so:

* each rank holds only its own vehicle rows: every stacked leaf is sharded
  over the vehicle axes on its leading dim, and the rank's local tensor is
  its row block (``core.vehicle_axis.VehicleSharding.local_rows``); nothing
  indexes the stacked dim of a DTensor, which would gather the stack;
* P1 solves every row on every rank (the small ``[V, V]`` matrices are
  gathered whole), as the sharded federation does;
* the mix (``mix_rows``) is written into the leaves' local tensors: each
  ``(fsdp, model)`` coordinate mixes its own shard with its peers along the
  vehicle axes, through ``core.vehicle_axis.sharded_mix`` one leaf at a time
  (a ``[V, ...]`` partial product and one reduce-scatter per leaf); on one
  vehicle shard it is the mesh-less mix above, in place where that one is.
  On the card this launches ``gossip_mix_matmul``;
* local training loops over the local rows, each row a DTensor on the
  ``(fsdp, model)`` sub-mesh placed by the spec without its vehicle entry,
  with the same autograd and leaf-by-leaf AdamW as above; plain tensors the
  model makes (positions, masks) count as replicated. Without a mesh the
  same code runs on plain rows of the whole stack;
* the results are redistributed to ``out_specs`` (the parameters and moments
  already are: they were updated in place); the loss is summed over the
  sub-mesh and averaged over the vehicle group.

The serving steps on a mesh take parameters placed by ``param_specs`` on the
production mesh (``data`` x ``model``), shard the tokens over the data axes
(replicated under ``replicate_batch``) and redistribute the logits and the
decode state to ``out_specs``. With ``mesh=None`` every step is the
single-device one above, unchanged.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from ..core import aggregation, kl_solver, state_vector
from ..core import vehicle_axis as va
from ..kernels.flash_attention.ops import make_train_attn_impl
from ..kernels.gossip_mix import kernel as mix_kernel
from ..kernels.gossip_mix.ops import mix_params_cuda, mix_params_cuda_
from ..models import transformer
from ..models.layers import is_dtensor
from ..optim import AdamState, adamw, apply_updates
from ..profiling import PhaseTimer, phase
from . import mesh as mesh_lib
from . import sharding as shard_lib
from .sharding import P

Tensor = torch.Tensor

_SEP = "/"


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dictionary's leaves by their ``/``-joined key path (the
    checkpoints' keys); the leaves themselves, not copies."""
    flat = {}
    for name, node in tree.items():
        if isinstance(node, dict):
            flat.update(flatten(node, f"{prefix}{name}{_SEP}"))
        else:
            flat[f"{prefix}{name}"] = node
    return flat


def unflatten(flat: dict) -> dict:
    """``flatten``'s inverse."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, name = key.split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


# ------------------------------------------------------------- training -----

@dataclass
class TrainStep:
    # (params, opt_state, state_matrix, tokens, contact, target[, prefix_embeds])
    #   -> (params, opt_state, state_matrix, metrics)
    fn: Callable
    in_specs: tuple              # spec trees, in the order of fn's arguments
    out_specs: tuple             # spec trees, in the order of fn's results
    param_specs: Any
    opt_specs: Any


# ------------------------------------------------------- on a DeviceMesh -----

def _whole(x):
    """The global tensor on every rank (a DTensor gathered; a plain tensor is
    taken as replicated)."""
    return x.full_tensor() if is_dtensor(x) else x


def _local(x):
    """A placed DTensor's local tensor (this rank's shard; writes reach it)."""
    if not is_dtensor(x):
        raise TypeError("on a mesh the round takes its state as DTensors placed by the "
                        "step's in_specs (convert.place_train_state)")
    return x.to_local()


def _vehicle_shard(mesh) -> va.VehicleSharding:
    """The vehicle axes of ``mesh`` as a ``VehicleSharding`` (its group, this
    rank's place in it; the pod and vehicle dims flattened into one)."""
    axes = mesh_lib.vehicle_axes(mesh)
    vmesh = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
    if vmesh.size() == 1:
        return va.GLOBAL
    return va.VehicleSharding(group=vmesh.get_group(), rank=vmesh.get_local_rank(),
                              num_shards=vmesh.size(),
                              staged=mesh_lib.transport() == "gloo_staged")


def _row_on(sub, local: Tensor, v: int, spec: P):
    """Row ``v`` of this rank's rows (``local``, sharded as ``spec`` over the
    sub-mesh on its trailing dims) as a DTensor on ``sub``; it shares
    ``local``'s storage."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local[v], sub, shard_lib.placements(spec, sub), run_check=False)


def _train_specs(cfg: ArchConfig, mesh):
    """The reference's specs of the round (its ``rng`` left out)."""
    if mesh is None:
        v_axes, fsdp = ("vehicle",), None
    else:
        v_axes = mesh_lib.vehicle_axes(mesh)
        fsdp = ("fsdp" if "fsdp" in mesh.mesh_dim_names
                and mesh_lib._shape(mesh)["fsdp"] > 1 else None)
    pspec = shard_lib.build_param_specs(cfg, fsdp=fsdp)
    pspec_v = shard_lib.prepend_axes(pspec, (v_axes,))
    opt_specs = AdamState(count=P(v_axes), mu=pspec_v, nu=pspec_v)
    in_specs = (
        pspec_v,                     # params
        opt_specs,                   # opt_state
        P(v_axes, None),             # state_matrix
        P(v_axes, fsdp, None),       # tokens [V, B, S]
        P(v_axes, None),             # contact
        P(None),                     # target
    )
    if cfg.embed_input:
        in_specs = in_specs + (P(v_axes, fsdp, None, None),)
    out_specs = (pspec_v, opt_specs, P(v_axes, None), {"loss": P(), "kl": P()})
    return in_specs, out_specs, pspec_v, opt_specs


def _mixes_in_place(mixing: Tensor) -> bool:
    """Whether the default mix writes a ``[V, V]`` mixing into the stack: on
    the CPU always (the plain product), on the card where ``gossip_mix_matmul``'s
    launcher mixes V x V in place (its column mapping)."""
    v = mixing.shape[-1]
    return not mixing.is_cuda or mix_kernel.matmul_path(v, v) == mix_kernel.MATMUL_COLUMNS


def mix_rows(mixing: Tensor, flat: dict, shard: va.VehicleSharding = va.GLOBAL,
             mix_params_fn=None) -> None:
    """The round's gossip mix of ``mixing`` ``[V, V]``, written into
    ``flat`` (``{path: [V_local, ...]}``, this rank's rows of every leaf).

    Over one vehicle shard: in place through ``mix_params_cuda_`` where
    ``_mixes_in_place``, no ``mix_params_fn`` is given and (on the card)
    every leaf is contiguous (a shard cut as a view may not be), else the
    functional mix (``mix_params_fn``, default ``mix_params_cuda``) of the
    whole dictionary, copied back. Over several: ``sharded_mix`` of that
    mix one leaf at a time (a ``[V, ...]`` partial product and its
    reduce-scatter), each copied back before the next, so that one leaf's
    partial product is the most the mix adds."""
    if shard.is_sharded:
        mix = va.sharded_mix(mix_params_fn or mix_params_cuda, shard)
        for name, leaf in flat.items():
            leaf.copy_(mix(mixing, {name: leaf})[name])
    elif mix_params_fn is None and _mixes_in_place(mixing) and (
            not mixing.is_cuda or all(x.is_contiguous() for x in flat.values())):
        mix_params_cuda_(mixing, flat)
    else:
        mixed = (mix_params_fn or mix_params_cuda)(mixing, flat)
        for name, leaf in flat.items():
            leaf.copy_(mixed[name])
        del mixed


def _model_parallel(mesh):
    """Where the round trains on a mesh: plain tensors the model makes
    (positions, masks) taken as replicated."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def build_dds_train_step(cfg: ArchConfig, *,
                         mesh=None,
                         local_steps: int = 1,
                         lr: float = 1e-4,
                         p1_steps: int = 100,
                         remat: bool = True,
                         attn_impl=None,
                         compute_dtype=None,
                         mix_params_fn=None,
                         timer: PhaseTimer | None = None) -> TrainStep:
    """One DFL-DDS global iteration over the stacked vehicle axis, for a
    transformer architecture.

    ``fn(params, opt_state, state_matrix, tokens, contact, target,
    prefix_embeds=None)``: ``params`` the nested tree of ``[V, ...]`` leaves,
    ``opt_state`` an ``AdamState`` (``count`` ``[V]`` int32, ``mu`` / ``nu``
    trees like ``params``), ``state_matrix`` ``[V, V]``, ``tokens``
    ``[V, B, S]``, ``contact`` the ``[V, V]`` 0/1 contact matrix, ``target``
    ``[V]``, ``prefix_embeds`` ``[V, B, P, d]`` for a VLM / audio
    configuration. Returns ``(params, opt_state, state_matrix, metrics)``:
    the first two updated in place, ``metrics`` ``{"loss": mean over vehicles
    and local steps, "kl": mean kl_to_target}`` (0-d tensors).

    ``mix_params_fn`` is a functional gossip mix of a flat ``{path: [V, ...]}``
    dictionary (``aggregation.mix_params``, the reference's default;
    ``aggregation.mix_params_lowp``), its output copied back into the leaves.
    Without one, the round mixes through the port's ``mixing_backend="cuda"``
    (one grouped ``gossip_mix_matmul`` launch for a model of one dtype on the
    card; the plain product for CPU leaves): in place through
    ``kernels.gossip_mix.ops.mix_params_cuda_`` where ``_mixes_in_place``,
    else through the functional ``mix_params_cuda`` and a copy back.
    ``compute_dtype`` runs the loss in that dtype on the f32 master weights
    (the cast is inside the loss, so the gradients reach the f32 leaves).
    ``attn_impl`` None attends through
    ``kernels.flash_attention.ops.make_train_attn_impl`` at the config's
    ``sliding_window``: the hand-written training attention, forward and
    backward, for CUDA bf16 q / k / v at an instantiated width pair (the bf16
    ``compute_dtype`` on the card), else the plain ``_sdpa`` with the causal
    mask (CPU or meta tensors, DTensors, f32, other widths); an explicit
    ``attn_impl`` is used as given.
    ``timer`` brackets the round's phases (``p1_solve``, ``mix``,
    ``local_train``, ``state_update``), as the federation engine's rounds,
    and each local step's ``forward``, ``backward`` (under ``remat`` with
    the recomputed forward) and ``adamw`` inside ``local_train``; where
    ``timer.blocks``, the model also opens its blocks' spans (``mla``,
    ``moe``) and the MoE's ``moe.held_rows`` counter on it
    (``models/transformer``).

    ``mesh`` runs the round on a federation mesh (module docstring):
    ``params`` and ``opt_state`` DTensors placed by ``in_specs``
    (``convert.place_train_state``), the other arguments DTensors so placed
    or plain tensors holding the same global values on every rank. A
    ``mix_params_fn`` must take a rectangular ``[V, V_local]`` block
    (``core.vehicle_axis.sharded_mix``).
    """
    optimizer = adamw(lr)
    in_specs, out_specs, pspec_v, opt_specs = _train_specs(cfg, mesh)
    if attn_impl is None:
        attn_impl = make_train_attn_impl(window=cfg.sliding_window)

    def loss_fn(leaves: dict, toks: Tensor, pre: Tensor | None) -> Tensor:
        if compute_dtype is not None:
            leaves = {name: x.to(compute_dtype) for name, x in leaves.items()}
        loss = transformer.lm_loss(unflatten(leaves), toks, cfg, prefix_embeds=pre,
                                   remat=remat, attn_impl=attn_impl,
                                   timer=timer if timer is not None and timer.blocks else None)
        if is_dtensor(loss):      # a partial sum over the sub-mesh, summed
            from torch.distributed.tensor import Replicate
            loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
        return loss

    def local_train(rows: dict, mu: dict, nu: dict, count: Tensor, toks: Tensor,
                    pre: Tensor | None) -> Tensor:
        """``local_steps`` AdamW steps of one vehicle, written in place into
        its rows of the parameters and moments and its counter. Returns the
        mean loss."""
        losses = []
        for _ in range(local_steps):
            with phase(timer, "forward"):
                leaves = {name: row.detach().requires_grad_() for name, row in rows.items()}
                loss = loss_fn(leaves, toks, pre)
            with phase(timer, "backward"):
                # a leaf the loss does not reach (a selection-only router
                # bias) gets a zero gradient
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()), allow_unused=True, materialize_grads=True)))
            del leaves
            with phase(timer, "adamw"), torch.no_grad():
                for name in list(grads):
                    g = {name: grads.pop(name)}
                    p = {name: rows[name]}
                    updates, new = optimizer.update(
                        g, AdamState(count=count, mu={name: mu[name]}, nu={name: nu[name]}), p)
                    mu[name].copy_(new.mu[name])
                    nu[name].copy_(new.nu[name])
                    rows[name].copy_(apply_updates(p, updates)[name])
                    del g, updates, new
                count += 1
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    sub = None if mesh is None else mesh["fsdp", "model"]
    row_specs = {name: shard_lib.drop_leading(spec) for name, spec in flatten(pspec_v).items()}

    def row(x: Tensor, v: int, spec: P):
        """Row ``v`` of this rank's rows: a view, on the mesh a DTensor of
        the ``(fsdp, model)`` sub-mesh sharing its storage."""
        return x[v] if sub is None else _row_on(sub, x, v, spec)

    def train_step(params: dict, opt_state: AdamState, state_matrix: Tensor, tokens: Tensor,
                   contact: Tensor, target: Tensor, prefix_embeds: Tensor | None = None):
        local = _local if mesh is not None else (lambda x: x)
        shard = va.GLOBAL if mesh is None else _vehicle_shard(mesh)
        sm, contact_g, target_g = _whole(state_matrix), _whole(contact), _whole(target)
        # -- P1: aggregation weights from the state vectors (Alg. 1 steps 1-2),
        #    every row on every rank
        with phase(timer, "p1_solve"):
            alpha = kl_solver.solve_p1_all(sm, target_g, contact_g, num_steps=p1_steps)
            mixing = aggregation.mixing_from_alpha(alpha, contact_g)
        # -- the gossip mix of every vehicle's model (Eq. 10), into this rank's rows
        flat = {name: local(leaf) for name, leaf in flatten(params).items()}
        with phase(timer, "mix"), torch.no_grad():
            mix_rows(mixing, flat, shard, mix_params_fn)
        # -- E local iterations per vehicle (Eq. 3), over this rank's rows
        mu = {name: local(x) for name, x in flatten(opt_state.mu).items()}
        nu = {name: local(x) for name, x in flatten(opt_state.nu).items()}
        count = local(opt_state.count)
        toks, pre = tokens, prefix_embeds
        if mesh is not None:
            toks = local(shard_lib.place(tokens, mesh, in_specs[3]))
            pre = None if pre is None else local(shard_lib.place(pre, mesh, in_specs[6]))
        tok_spec = shard_lib.drop_leading(in_specs[3])
        pre_spec = shard_lib.drop_leading(in_specs[6]) if pre is not None else None
        losses = []
        with phase(timer, "local_train"), _model_parallel(mesh):
            for v in range(count.shape[0]):
                rows = [{name: row(x, v, row_specs[name]) for name, x in tree.items()}
                        for tree in (flat, mu, nu)]
                losses.append(_whole(local_train(
                    *rows, count[v], row(toks, v, tok_spec),
                    None if pre is None else row(pre, v, pre_spec))))
        # -- the state vectors (Eqs. 5-7), and the results at out_specs
        with phase(timer, "state_update"):
            new_sm = state_vector.aggregate(sm, mixing)
            new_sm = state_vector.local_update(new_sm, lr, local_steps)
            metrics = {"loss": shard.pmean(torch.stack(losses).mean()),
                       "kl": torch.mean(state_vector.kl_to_target(new_sm, target_g))}
            if is_dtensor(state_matrix):
                new_sm = shard_lib.place(new_sm, mesh, out_specs[2])
        return params, opt_state, new_sm, metrics

    return TrainStep(fn=train_step,
                     in_specs=in_specs, out_specs=out_specs, param_specs=pspec_v,
                     opt_specs=opt_specs)


def init_train_state(cfg: ArchConfig, num_vehicles: int, generator: torch.Generator,
                     dtype=torch.float32, device=None):
    """``(params, opt_state, state_matrix)`` of a federation of
    ``num_vehicles``: one model drawn from ``generator`` (on ``device``, the
    generator's when not given) copied to every vehicle, as the reference's
    ``broadcast_to(...).copy()``; AdamW's zero moments and ``[V]`` counters;
    the all-zero state matrix."""
    one = flatten(transformer.init_params(generator, cfg, dtype=dtype, device=device))
    flat = {name: leaf.unsqueeze(0).expand((num_vehicles,) + tuple(leaf.shape)).clone()
            for name, leaf in one.items()}
    del one
    opt = adamw(1e-4).init(flat, num_stacked=num_vehicles)
    return (unflatten(flat),
            AdamState(count=opt.count, mu=unflatten(opt.mu), nu=unflatten(opt.nu)),
            state_vector.init_state(num_vehicles, device=opt.count.device))


def train_state_specs(cfg: ArchConfig, num_vehicles: int) -> tuple:
    """Meta tensors for (params, opt_state, state_matrix), stacked ``[V]``:
    the shapes and dtypes of ``init_train_state``, no storage."""
    meta = torch.device("meta")
    one = flatten(transformer.init_params(torch.Generator(), cfg, device=meta))
    params = {name: torch.empty((num_vehicles,) + tuple(x.shape), dtype=x.dtype, device=meta)
              for name, x in one.items()}
    moments = lambda: unflatten({name: torch.empty(x.shape, dtype=torch.float32, device=meta)
                                 for name, x in params.items()})
    opt = AdamState(count=torch.empty((num_vehicles,), dtype=torch.int32, device=meta),
                    mu=moments(), nu=moments())
    sm = torch.empty((num_vehicles, num_vehicles), dtype=torch.float32, device=meta)
    return unflatten(params), opt, sm


# -------------------------------------------------------------- serving -----

@dataclass
class ServeStep:
    fn: Callable
    in_specs: tuple
    out_specs: tuple
    param_specs: Any


def _batch_axis(mesh, replicate: bool = False):
    if replicate:
        return None
    d_axes = ("data",) if mesh is None else mesh_lib.data_axes(mesh)
    return d_axes[0] if len(d_axes) == 1 else d_axes


def _on_mesh(fn, mesh, in_specs: tuple, out_specs: tuple):
    """``fn`` on ``mesh``: the arguments after the parameters placed by
    ``in_specs`` (the parameters, already placed, pass), plain tensors the
    model makes taken as replicated, the results redistributed to
    ``out_specs``."""
    def run(params, *args):
        from torch.distributed.tensor.experimental import implicit_replication
        args = [shard_lib.place_tree(x, mesh, spec) for x, spec in zip(args, in_specs[1:])]
        with implicit_replication():
            out = fn(params, *args)
        return shard_lib.place_tree(out, mesh, out_specs)

    return run


def build_prefill_step(cfg: ArchConfig, *, mesh=None, attn_impl=None,
                       window: int | None = None) -> ServeStep:
    """``fn(params, tokens, prefix_embeds=None)`` -> ``transformer.prefill``'s
    (last logits, DecodeState); on ``mesh``, the parameters placed by
    ``param_specs``."""
    b_ax = _batch_axis(mesh)

    def prefill_step(params, tokens, prefix_embeds=None):
        return transformer.prefill(params, tokens, cfg, prefix_embeds=prefix_embeds,
                                   window=window, attn_impl=attn_impl)

    pspec = shard_lib.build_param_specs(cfg)
    in_specs = (pspec, P(b_ax, None))
    if cfg.embed_input:
        in_specs = in_specs + (P(b_ax, None, None),)
    out_specs = (P(b_ax, "model"), shard_lib.decode_state_specs(cfg, b_ax))
    fn = prefill_step if mesh is None else _on_mesh(prefill_step, mesh, in_specs, out_specs)
    return ServeStep(fn=fn, in_specs=in_specs, out_specs=out_specs, param_specs=pspec)


def build_decode_step(cfg: ArchConfig, *, mesh=None,
                      replicate_batch: bool = False) -> ServeStep:
    """``fn(params, tokens, state)`` -> ``transformer.decode_step``'s (logits,
    DecodeState); the state's tensors are written in place. On ``mesh`` the
    batch is sharded over the data axes, or replicated with
    ``replicate_batch``."""
    b_ax = _batch_axis(mesh, replicate_batch)

    def decode_fn(params, tokens, state):
        return transformer.decode_step(params, tokens, state, cfg)

    pspec = shard_lib.build_param_specs(cfg)
    state_specs = shard_lib.decode_state_specs(cfg, b_ax)
    in_specs = (pspec, P(b_ax, None), state_specs)
    out_specs = (P(b_ax, "model"), state_specs)
    fn = decode_fn if mesh is None else _on_mesh(decode_fn, mesh, in_specs, out_specs)
    return ServeStep(fn=fn, in_specs=in_specs, out_specs=out_specs, param_specs=pspec)


# ------------------------------------------------------------- helpers ------

def named(mesh, spec_tree):
    """Spec tree -> the tree of DTensor placements on ``mesh``."""
    return shard_lib.placements_tree(spec_tree, mesh)
