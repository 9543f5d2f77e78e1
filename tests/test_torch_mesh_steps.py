"""The mesh-aware steps of ``launch/steps`` on real process groups (gloo, on
the CPU), against the single-device steps and the reference.

* One rank, mesh (1, 1, 1): a DDS round of the reduced qwen3-1.7b at V = 4
  from ``convert.place_train_state`` equals the ``mesh=None`` round bit for
  bit (parameters, AdamW moments and counters, state matrix, loss, kl), with
  every local tensor the converted leaf itself; and it agrees with the
  reference's ``build_dds_train_step`` on its one-device mesh to
  ``test_torch_train_step.py``'s tolerances (loss, kl, state matrix 1e-5;
  parameters and moments 1e-4).
* One rank, serving mesh (1, 1): prefill and decode equal ``mesh=None`` bit
  for bit.
* One rank, the train step's AdamW on the kernel's route (the CPU taken off
  ``steps.PER_LEAF_DEVICES``, the kernel stood in for by its plain ops behind
  its own checks): the kernel gets each leaf's local shards as plain
  contiguous tensors, and the round equals the ``mesh=None`` round bit for
  bit.
* Two spawned ranks, one group, several meshes on it, each against
  ``mesh=None`` within 1e-5 (each train mesh also on the kernel's route):

  - (2, 1, 1): each rank draws only its own two vehicles' rows
    (``convert.vehicle_rows``, ``place_train_state(local_rows=True)``),
    trains them and mixes through ``sharded_mix``'s reduce-scatter;
  - (1, 1, 2) and (1, 2, 1): the round with every leaf sharded over
    ``model`` (tensor-parallel attention and MLP, the vocabulary-parallel
    embedding, gradients through ``layers.on_shards``) or over ``fsdp``,
    placed from numpy (each rank copies only its block);
  - serving meshes (1, 2) and (2, 1) (``data`` x ``model``): prefill and three
    decode steps of the reduced qwen3 (its KV cache sharded over its sequence
    on ``model``: ``write_slot``), and on (1, 2) of the reduced mixtral (its
    experts on the shards), logits and caches; the ragged MoE
    (``moe_impl="ragged"``: the grouped products on each rank's shards) of
    mixtral on (1, 2) (its experts' hidden dim split, a partial sum) and of
    granite-moe on (2, 1) (its tokens split).
"""
import contextlib
import dataclasses
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.launch import steps as jsteps
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.launch.sharding import place_tree
from repro_torch.models import transformer
from repro_torch.optim import AdamState

from test_torch_train_step import B, LR, P1_STEPS, S, V, _ring, _start_state
from test_torch_train_step import _one_thread  # noqa: F401  (autouse: one intra-op thread)

# the shapes of the meshes the two spawned ranks run on
TRAIN_MESHES = {"vehicle2": (2, 1, 1), "model2": (1, 1, 2), "fsdp2": (1, 2, 1)}
SERVE_MESHES = {"model2": (1, 2), "data2": (2, 1)}
# (mesh, arch[:moe_impl]): the MoE's experts are split over ``model`` only
SERVE_CASES = [("model2", "qwen3-1.7b"), ("model2", "mixtral-8x7b"), ("data2", "qwen3-1.7b"),
               ("model2", "mixtral-8x7b:ragged"), ("data2", "granite-moe-1b-a400m:ragged")]

ARCH = "qwen3-1.7b"


def _case():
    """Numpy inputs of one round: the reduced qwen3's federation mid-training,
    tokens, ring contacts, uniform target."""
    params, opt, sm = _start_state(jax_get_config(ARCH).reduced(), 11)
    r = np.random.default_rng(5)
    tok = r.integers(0, get_config(ARCH).reduced().true_vocab_size,
                     size=(V, B, S)).astype(np.int32)
    return dict(params=params, opt=opt, sm=sm, tok=tok, contact=_ring(V),
                target=np.full((V,), 1.0 / V, np.float32))


def _numpy_state(case, rows=slice(None)):
    """The round's start as numpy ``(params, AdamState, state_matrix)``: all
    rows, or ``rows`` of every leaf."""
    tree = lambda t: {k: (tree(x) if isinstance(x, dict) else x[rows]) for k, x in t.items()}
    opt = case["opt"]
    return (tree(case["params"]),
            AdamState(count=opt.count[rows], mu=tree(opt.mu), nu=tree(opt.nu)), case["sm"][rows])


def _round(case, mesh=None, state=None, **place_kw):
    """One round of the port (on ``mesh`` from the placed state: the
    converted tensors, or ``state`` as given); returns the step, the state it
    started from and its outputs."""
    cfg = get_config(ARCH).reduced()
    ts = steps.build_dds_train_step(cfg, mesh=mesh, lr=LR, remat=False, p1_steps=P1_STEPS)
    if state is None:
        state = convert.train_state_from_numpy(case["params"], case["opt"], case["sm"])
    start = (state if mesh is None
             else convert.place_train_state(state, mesh, ts.in_specs, **place_kw))
    out = ts.fn(*start, torch.as_tensor(case["tok"]), torch.as_tensor(case["contact"]),
                torch.as_tensor(case["target"]))
    return ts, state, start, out


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _serve(arch: str, mesh=None) -> list:
    """Prefill of two 12-token prompts and three decode steps of the reduced
    ``arch`` (``name:ragged`` with the ragged MoE; on ``mesh``, its parameters
    placed by the step's specs): every logits and the final KV cache (in
    f32), whole."""
    name, _, moe_impl = arch.partition(":")
    cfg = get_config(name).reduced()
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    tok = torch.randint(0, cfg.true_vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(4))
    prefill = steps.build_prefill_step(cfg, mesh=mesh)
    decode = steps.build_decode_step(cfg, mesh=mesh)
    if mesh is not None:
        params = place_tree(params, mesh, prefill.param_specs)
    logits, state = prefill.fn(params, tok)
    out = [logits]
    for t in range(3):
        logits, state = decode.fn(params, tok[:, t:t + 1], state)
        out.append(logits)
    return [_whole(x).detach().float() for x in out + [state.kv.k, state.kv.v]]


def _flat_state(out, local: bool = True) -> dict:
    """Every tensor of a round's output, by name, as this rank holds it (or
    the DTensors themselves)."""
    params, opt, sm, metrics = out
    get = _local if local else (lambda x: x)
    flat = {f"params/{k}": get(x) for k, x in steps.flatten(params).items()}
    flat.update({f"mu/{k}": get(x) for k, x in steps.flatten(opt.mu).items()})
    flat.update({f"nu/{k}": get(x) for k, x in steps.flatten(opt.nu).items()})
    flat.update(count=get(opt.count), sm=get(sm), loss=metrics["loss"], kl=metrics["kl"])
    return flat


# the AdamW kernel's stand-in: the leaves of each of its calls
STAND_IN_CALLS: list[int] = []


def _plain_adamw_(params, grads, mu, nu, c1, c2, *, lr, b1, b2, eps, weight_decay):
    """The AdamW kernel's stand-in on CPU tensors: its wrapper's checks
    (plain, contiguous f32 of one shape on one device), then
    ``optim.adamw``'s ops in their order, written in place."""
    adamw_kernel.check_leaves(params, grads, mu, nu)
    STAND_IN_CALLS.append(len(params))
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        p.copy_(p + -lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p))


@contextlib.contextmanager
def _kernel_route():
    """The train step's AdamW on the kernel's route with CPU tensors (the CPU
    off ``steps.PER_LEAF_DEVICES``, ``_plain_adamw_`` for the kernel)."""
    saved = steps.PER_LEAF_DEVICES, adamw_kernel.adamw_
    steps.PER_LEAF_DEVICES, adamw_kernel.adamw_ = ("meta",), _plain_adamw_
    try:
        yield
    finally:
        steps.PER_LEAF_DEVICES, adamw_kernel.adamw_ = saved


# ------------------------------------------------------------ two ranks -----

def _held_fraction(placed) -> float:
    """The bytes of the storages behind this rank's local parameters and
    moments, over the bytes of the global stack they are placed from; 1.0
    if any local tensor is a view of a larger storage."""
    params, opt, _ = placed
    leaves = [x for tree in (params, opt.mu, opt.nu) for x in steps.flatten(tree).values()]
    local = [x.to_local() for x in leaves]
    if any(t.untyped_storage().nbytes() != t.numel() * t.element_size() for t in local):
        return 1.0
    return (sum(t.numel() * t.element_size() for t in local)
            / sum(x.numel() * x.element_size() for x in leaves))


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(init_method=f"file://{os.path.join(workdir, 'store')}",
                                  num_processes=2, process_id=rank, transport="gloo")
    with open(os.path.join(workdir, "case.pkl"), "rb") as f:
        case = pickle.load(f)
    got = {}
    for route, context in (("", contextlib.nullcontext), ("kernel/", _kernel_route)):
        for name, (vehicle, fsdp, model) in TRAIN_MESHES.items():
            mesh = mesh_lib.make_federation_mesh(vehicle=vehicle, fsdp=fsdp, model=model,
                                                 explicit=True)
            with context():
                if vehicle > 1:      # this rank's rows only: the stack is never whole here
                    own = _numpy_state(case, convert.vehicle_rows(mesh, V))
                    _, _, start, out = _round(case, mesh, own, local_rows=True)
                    flat = _flat_state(out)
                else:
                    _, _, start, out = _round(case, mesh, _numpy_state(case))
                    flat = {k: _whole(x) for k, x in _flat_state(out, local=False).items()}
            got[route + name] = {k: x.detach().clone().numpy() for k, x in flat.items()}
            got[f"held/{route}{name}"] = _held_fraction(start)
    got["stand_in_calls"] = list(STAND_IN_CALLS)
    for name, arch in SERVE_CASES:
        mesh = mesh_lib._mesh(SERVE_MESHES[name], ("data", "model"))
        got[f"{name}/{arch}"] = [x.numpy() for x in _serve(arch, mesh)]
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(got, f)
    mesh_lib.shutdown()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks, started before the one-rank tests run and joined when
    a test asks for their rows."""
    root = tmp_path_factory.mktemp("mesh2")
    case = _case()
    with open(root / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    ctx = mp.start_processes(_rank_main, args=(str(root),), nprocs=2, join=False,
                             start_method="spawn")

    def join():
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail("the 2-rank spawn did not finish in time")
        return [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(2)]

    return case, join


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory, spawned):
    """A one-rank gloo group for this module; torn down with its meshes."""
    store = tmp_path_factory.mktemp("mesh1") / "store"
    assert mesh_lib.initialize_multihost(init_method=f"file://{store}", num_processes=1,
                                         process_id=0, transport="gloo") == 1
    yield mesh_lib.make_federation_mesh(vehicle=1, fsdp=1, model=1, explicit=True)
    mesh_lib.shutdown()


@pytest.fixture(scope="module")
def rounds(one_rank, spawned):
    case, _ = spawned
    return case, _round(case), _round(case, one_rank)


def test_one_rank_mesh_round_equals_the_meshless_round(rounds):
    _, (_, _, _, want), (ts, state, start, got) = rounds
    want, got = _flat_state(want), _flat_state(got)
    assert sorted(got) == sorted(want)
    for name, x in got.items():
        assert torch.equal(x, want[name]), name
    # the placed state is the converted one, leaf for leaf: each local tensor
    # is the leaf's storage, written in place by the round
    for tree, placed in zip(state[:2], start[:2]):
        for a, b in zip(steps.flatten(tree._asdict() if hasattr(tree, "_asdict") else tree)
                        .values(), steps.flatten(placed._asdict() if hasattr(placed, "_asdict")
                                                  else placed).values()):
            assert _local(b).data_ptr() == a.data_ptr()
    assert ts.in_specs[0]["blocks"]["attn"]["wq"] == (("vehicle",), None, None, "model")
    assert ts.out_specs[3] == {"loss": (), "kl": ()}


def test_one_rank_mesh_round_on_the_kernel_route_gives_the_meshless_bits(rounds, one_rank):
    """On the kernel's route the mesh round hands the kernel each vehicle's
    leaves as this rank's plain local tensors, one call a vehicle step, and
    its writes reach the placed state: the round equals ``mesh=None`` bit
    for bit."""
    case, (_, _, _, want), _ = rounds
    STAND_IN_CALLS.clear()
    with _kernel_route():
        _, _, _, got = _round(case, one_rank)
    leaves = len(steps.flatten(case["params"]))
    assert STAND_IN_CALLS == [leaves] * V
    want, got = _flat_state(want), _flat_state(got)
    for name, x in got.items():
        assert torch.equal(x, want[name]), name


def test_one_rank_mesh_round_matches_reference(rounds):
    case, _, (_, _, _, out) = rounds
    jcfg = jax_get_config(ARCH).reduced()
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("vehicle", "fsdp", "model"))
    ts = jsteps.build_dds_train_step(jcfg, mesh, lr=LR, remat=False, p1_steps=P1_STEPS)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(ts.fn)(*jax.tree_util.tree_map(
        jnp.asarray, (case["params"], case["opt"], case["sm"], case["tok"], case["contact"],
                      case["target"])), jax.random.PRNGKey(2)))
    got = _flat_state(out)
    for name in ("loss", "kl"):
        assert abs(float(got[name]) - float(want[3][name])) <= 1e-5, name
    np.testing.assert_allclose(got["sm"].numpy(), want[2], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["count"].numpy(), want[1].count)
    for what, tree in (("params", want[0]), ("mu", want[1].mu), ("nu", want[1].nu)):
        for k, leaf in steps.flatten(tree).items():
            np.testing.assert_allclose(got[f"{what}/{k}"].numpy(), leaf, rtol=0, atol=1e-4,
                                       err_msg=f"{what}/{k}")


def test_one_rank_serving_steps_equal_the_meshless_steps(one_rank):
    cfg = get_config(ARCH).reduced()
    mesh = mesh_lib._mesh((1, 1), ("data", "model"))
    from repro_torch.launch.sharding import place_tree
    from repro_torch.models import transformer
    params = transformer.init_params(torch.Generator().manual_seed(3), cfg)
    tok = torch.randint(0, cfg.true_vocab_size, (2, 12), generator=torch.Generator().manual_seed(4))
    plain_pre, mesh_pre = steps.build_prefill_step(cfg), steps.build_prefill_step(cfg, mesh=mesh)
    placed = place_tree(params, mesh, mesh_pre.param_specs)
    last, state = plain_pre.fn(params, tok)
    m_last, m_state = mesh_pre.fn(placed, tok)
    assert torch.equal(m_last.to_local(), last)
    for a, b in zip(steps.flatten(state.kv._asdict()).values(),
                    steps.flatten(m_state.kv._asdict()).values()):
        assert torch.equal(b.to_local(), a)
    plain_dec = steps.build_decode_step(cfg)
    mesh_dec = steps.build_decode_step(cfg, mesh=mesh, replicate_batch=True)
    assert mesh_dec.in_specs[1] == (None, None)
    for t in range(3):
        logits, state = plain_dec.fn(params, tok[:, t:t + 1], state)
        m_logits, m_state = mesh_dec.fn(placed, tok[:, t:t + 1], m_state)
        assert torch.equal(m_logits.to_local(), logits), t
    assert torch.equal(m_state.kv.k.to_local(), state.kv.k)
    assert int(m_state.position.to_local()) == int(state.position)


@pytest.fixture(scope="module")
def two_ranks(spawned):
    _, join = spawned
    return join()


def test_two_ranks_train_their_rows_and_mix_by_reduce_scatter(two_ranks, rounds):
    _, (_, _, _, want), _ = rounds
    want = _flat_state(want)
    for name, x in want.items():
        x = x.numpy()
        if name in ("loss", "kl"):                   # replicated on both ranks
            for r in two_ranks:
                np.testing.assert_allclose(r["vehicle2"][name], x, rtol=0, atol=1e-5,
                                           err_msg=name)
        else:                                        # each rank its two vehicle rows
            got = np.concatenate([r["vehicle2"][name] for r in two_ranks])
            np.testing.assert_allclose(got, x, rtol=0, atol=1e-5, err_msg=name)


def test_two_ranks_hold_only_their_block_of_the_stack(two_ranks):
    """Placed from per-rank rows or from numpy, a rank's parameters and
    moments are storages of their own: half the stack on (2, 1, 1); on
    (1, 1, 2) and (1, 2, 1) half of every sharded leaf and the replicated
    ones whole (the norms; over ``fsdp`` also the embedding and the head)."""
    for rank, r in enumerate(two_ranks):
        assert r["held/vehicle2"] == 0.5, rank
        for name in ("model2", "fsdp2"):
            assert 0.5 <= r[f"held/{name}"] < 0.6, (name, rank, r[f"held/{name}"])


@pytest.mark.parametrize("mesh_name", ["model2", "fsdp2"])
def test_two_ranks_train_a_model_sharded_round(two_ranks, rounds, mesh_name):
    """Every leaf sharded over ``model`` (or ``fsdp``) on both ranks: the
    round's parameters, moments, counters, state matrix and metrics, whole
    on each rank, within 1e-5 of ``mesh=None``."""
    _, (_, _, _, want), _ = rounds
    for name, x in _flat_state(want).items():
        for rank, r in enumerate(two_ranks):
            np.testing.assert_allclose(r[mesh_name][name], x.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{mesh_name} rank {rank}: {name}")


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_two_ranks_train_on_the_kernel_route(two_ranks, rounds, mesh_name):
    """The train meshes with the round's AdamW on the kernel's route (each
    rank's shards, a gradient placed otherwise than its row first placed as
    it): the same state as the per-leaf route on each rank, and within 1e-5
    of ``mesh=None``; the kernel took every vehicle step of every mesh."""
    _, (_, _, _, want), _ = rounds
    leaves = len(steps.flatten(_case()["params"]))
    for rank, r in enumerate(two_ranks):
        assert r["stand_in_calls"] == [leaves] * (2 + 4 + 4), rank
        assert r[f"held/kernel/{mesh_name}"] == r[f"held/{mesh_name}"], rank
        for name, x in r[f"kernel/{mesh_name}"].items():
            np.testing.assert_allclose(x, r[mesh_name][name], rtol=0, atol=1e-6,
                                       err_msg=f"{mesh_name} rank {rank}: {name}")
    if mesh_name == "vehicle2":
        return
    for name, x in _flat_state(want).items():
        for rank, r in enumerate(two_ranks):
            np.testing.assert_allclose(r[f"kernel/{mesh_name}"][name], x.numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{mesh_name} rank {rank}: {name}")


@pytest.mark.parametrize("mesh_name,arch", SERVE_CASES)
def test_two_ranks_serve_on_a_sharded_mesh(two_ranks, mesh_name, arch):
    """Prefill and three decode steps on a ``data`` x ``model`` mesh of the
    two ranks: the four logits within 1e-5 of ``mesh=None``; the KV cache,
    held in bf16, within 1e-5 plus one bf16 unit in the last place (rtol
    2**-7): the f32 values it rounds are sums taken in another order on the
    shards, and a last-bit difference may round the other way."""
    want = _serve(arch)
    for rank, r in enumerate(two_ranks):
        got = r[f"{mesh_name}/{arch}"]
        for i, (g, x) in enumerate(zip(got, want)):
            tol = dict(rtol=0, atol=1e-5) if i < 4 else dict(rtol=2**-7, atol=1e-5)
            np.testing.assert_allclose(g, x.numpy(), **tol,
                                       err_msg=f"{mesh_name} rank {rank}: output {i}")
