"""Port vs reference, the gossip_mix kernels' module: the port's plain
versions, ``mix_params_cuda`` and its in-place twin ``mix_params_cuda_`` on
CPU tensors against the Pallas kernels run in interpret mode, at the
reference's sweep shapes.

Tolerances are the reference's own (tests/test_kernels.py): f32 atol 1e-5
(sums of <= 100 products in another order), bf16 atol 5e-2 (one bf16
rounding of O(1) values). The CUDA kernels themselves run only on a GPU:
their tests are in tests/test_torch_cuda.py (marker ``cuda``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import contacts as ref_contacts
from repro.kernels.gossip_mix import (gossip_mix_gather, gossip_mix_matmul,
                                      mix_params_pallas)
from repro_torch.core import aggregation, contacts
from repro_torch.kernels.gossip_mix import (gossip_mix_gather_ref,
                                            gossip_mix_matmul_ref, kernel,
                                            mix_params_cuda, mix_params_cuda_)

T = torch.as_tensor
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

SWEEP = [(7, 33, jnp.float32), (16, 512, jnp.float32), (64, 2048, jnp.float32),
         (100, 700, jnp.float32), (12, 257, jnp.bfloat16), (8, 128, jnp.bfloat16)]


def _tol(dtype):
    return 1e-5 if dtype == jnp.float32 else 5e-2


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _dense_case(k_out, k_in, p, dtype, seed):
    r = np.random.default_rng(seed)
    w = r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32)
    x = r.normal(size=(k_in, p)).astype(np.float32)
    return w, jnp.asarray(x, dtype), T(x).to(TORCH_DTYPE[dtype])


def _sparse_case(k_out, k_in, d, p, dtype, seed):
    r = np.random.default_rng(seed)
    idx = r.integers(0, k_in, size=(k_out, d)).astype(np.int32)
    w = r.random((k_out, d)).astype(np.float32)
    w[:, -1] = 0.0                                   # a zero-weight padding slot
    x = r.normal(size=(k_in, p)).astype(np.float32)
    return idx, w, jnp.asarray(x, dtype), T(x).to(TORCH_DTYPE[dtype])


@pytest.mark.parametrize("k,p,dtype", SWEEP)
def test_matmul_ref_matches_pallas_interpret(k, p, dtype):
    w, xj, xt = _dense_case(k, k, p, dtype, k * 1000 + p)
    want = gossip_mix_matmul(jnp.asarray(w), xj, interpret=True)
    got = gossip_mix_matmul_ref(T(w), xt)
    assert got.dtype == xt.dtype and got.shape == (k, p)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dtype))


@pytest.mark.parametrize("k_out,k_in,p", [(3, 8, 130), (8, 4, 257)])
def test_matmul_ref_rectangular(k_out, k_in, p):
    w, xj, xt = _dense_case(k_out, k_in, p, jnp.float32, 5)
    want = gossip_mix_matmul(jnp.asarray(w), xj, interpret=True)
    got = gossip_mix_matmul_ref(T(w), xt)
    assert got.shape == (k_out, p)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


@pytest.mark.parametrize("k,p,dtype", SWEEP + [(8, 260, jnp.float32)])
def test_gather_ref_matches_pallas_interpret(k, p, dtype):
    d = 5
    idx, w, xj, xt = _sparse_case(k, k, d, p, dtype, 9 + k)
    want = gossip_mix_gather(jnp.asarray(idx), jnp.asarray(w), xj, interpret=True)
    got = gossip_mix_gather_ref(T(idx), T(w), xt)
    assert got.dtype == xt.dtype and got.shape == (k, p)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_tol(dtype))
    # the slot loop of core.contacts is the same function
    loop = contacts.sparse_mix_array(contacts.SparseMixing(T(idx), T(w)), xt)
    np.testing.assert_allclose(_f32(loop), _f32(want), atol=_tol(dtype))


def test_gather_ref_rectangular():
    idx, w, xj, xt = _sparse_case(5, 11, 4, 140, jnp.float32, 3)
    want = gossip_mix_gather(jnp.asarray(idx), jnp.asarray(w), xj, interpret=True)
    got = gossip_mix_gather_ref(T(idx), T(w), xt)
    assert got.shape == (5, 140)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_mix_params_cuda_on_cpu_matches_mix_params_pallas(sparse, dtype):
    r = np.random.default_rng(0)
    k = 6
    tree = {"a": r.normal(size=(k, 3, 5)).astype(np.float32),
            "b": r.normal(size=(k, 11)).astype(np.float32)}
    tree_j = {n: jnp.asarray(v, dtype) for n, v in tree.items()}
    tree_t = {n: T(v).to(TORCH_DTYPE[dtype]) for n, v in tree.items()}
    if sparse:
        idx, w, _, _ = _sparse_case(k, k, 4, 1, jnp.float32, 1)
        mix_j = ref_contacts.SparseMixing(jnp.asarray(idx), jnp.asarray(w))
        mix_t = contacts.SparseMixing(T(idx), T(w))
    else:
        w = r.dirichlet(np.ones(k), size=k).astype(np.float32)
        mix_j, mix_t = jnp.asarray(w), T(w)
    want = mix_params_pallas(mix_j, tree_j, interpret=True)
    got = mix_params_cuda(mix_t, tree_t)
    plain = aggregation.mix_params(mix_t, tree_t)
    for n in tree:
        assert got[n].shape == tree[n].shape and got[n].dtype == tree_t[n].dtype
        np.testing.assert_allclose(_f32(got[n]), _f32(want[n]), atol=_tol(dtype))
        np.testing.assert_allclose(_f32(got[n]), _f32(plain[n]), atol=_tol(dtype))


def test_mix_params_cuda_rectangular_leaf_shapes():
    r = np.random.default_rng(2)
    w = r.dirichlet(np.ones(7), size=3).astype(np.float32)        # [3, 7]
    tree = {"a": T(r.normal(size=(7, 2, 4)).astype(np.float32))}
    out = mix_params_cuda(T(w), tree)["a"]
    assert out.shape == (3, 2, 4)
    want = mix_params_pallas(jnp.asarray(w), {"a": jnp.asarray(tree["a"].numpy())},
                             interpret=True)["a"]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_calls_launch_no_kernel():
    kernel.reset_launch_counts()
    w = T(np.eye(4, dtype=np.float32))
    mix_params_cuda(w, {"a": torch.ones(4, 3)})
    assert kernel.launch_counts == {"gossip_mix_gather": 0, "gossip_mix_matmul": 0}


@pytest.mark.parametrize("call", ["gather", "matmul", "matmul_out"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The wrappers launch or raise: a CPU tensor is not silently routed to
    the plain version there (only ``ops`` dispatches on the device), and
    neither is an in-place mix (``out=``)."""
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if call == "gather":
            kernel.gossip_mix_gather(torch.zeros(4, 2, dtype=torch.int32),
                                     torch.ones(4, 2), x)
        elif call == "matmul":
            kernel.gossip_mix_matmul(torch.eye(4), x)
        else:
            kernel.gossip_mix_matmul_grouped(torch.eye(4), [x], out=[x])


# ------------------------------------------------- the in-place mix ---

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 16])
def test_mix_params_cuda__on_cpu_matches_mix_params_pallas(k, dtype):
    """``mix_params_cuda_`` on CPU leaves (the train round's default mix, few
    vehicles) against the reference's Pallas mix in interpret mode and the
    port's ``aggregation.mix_params`` on the same inputs; it writes into the
    leaves (same tensors, same storage) and returns the same dictionary."""
    r = np.random.default_rng(k)
    tree = {"a": r.normal(size=(k, 3, 5)).astype(np.float32),
            "b": r.normal(size=(k, 11)).astype(np.float32),
            "c": r.normal(size=(k, 2, 2, 7)).astype(np.float32)}
    w = r.dirichlet(np.ones(k), size=k).astype(np.float32)
    want = mix_params_pallas(jnp.asarray(w), {n: jnp.asarray(v, dtype) for n, v in tree.items()},
                             interpret=True)
    tree_t = {n: T(v).to(TORCH_DTYPE[dtype]) for n, v in tree.items()}
    plain = aggregation.mix_params(T(w), tree_t)
    leaves = dict(tree_t)
    ptrs = {n: x.data_ptr() for n, x in tree_t.items()}
    kernel.reset_launch_counts()
    got = mix_params_cuda_(T(w), tree_t)
    assert got is tree_t and all(got[n] is leaves[n] for n in tree)
    assert {n: x.data_ptr() for n, x in got.items()} == ptrs
    assert kernel.launch_counts == {"gossip_mix_gather": 0, "gossip_mix_matmul": 0}
    for n in tree:
        assert got[n].shape == tree[n].shape and got[n].dtype == TORCH_DTYPE[dtype]
        np.testing.assert_allclose(_f32(got[n]), _f32(want[n]), atol=_tol(dtype))
        np.testing.assert_allclose(_f32(got[n]), _f32(plain[n]), atol=_tol(dtype))


def test_mix_params_cuda__with_a_seed_axis_on_cpu():
    """``[S, K, K]`` over ``[S, K, ...]`` leaves, in place: each seed's W on
    its own slab, as ``aggregation.mix_params`` mixes them."""
    r = np.random.default_rng(4)
    s, k = 3, 4
    w = T(r.dirichlet(np.ones(k), size=(s, k)).astype(np.float32))
    tree = {"a": T(r.normal(size=(s, k, 3, 5)).astype(np.float32)),
            "b": T(r.normal(size=(s, k, 7)).astype(np.float32))}
    want = aggregation.mix_params(w, tree)
    got = mix_params_cuda_(w, tree)
    for n in tree:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=1e-6)


@pytest.mark.parametrize("mixing", ["sparse", "rectangular", "rectangular_seeds"])
def test_mix_params_cuda__refuses_what_it_cannot_mix_in_place(mixing):
    """A neighbour list or a rectangular W has no in-place mix: it raises,
    and no leaf is touched."""
    r = np.random.default_rng(1)
    tree = {"a": T(r.normal(size=(4, 6)).astype(np.float32))}
    before = tree["a"].clone()
    if mixing == "sparse":
        idx, w, _, _ = _sparse_case(4, 4, 3, 1, jnp.float32, 2)
        with pytest.raises(TypeError):
            mix_params_cuda_(contacts.SparseMixing(T(idx), T(w)), tree)
    elif mixing == "rectangular":
        with pytest.raises(ValueError, match="square"):
            mix_params_cuda_(T(r.dirichlet(np.ones(4), size=3).astype(np.float32)), tree)
    else:
        with pytest.raises(ValueError, match="square"):
            mix_params_cuda_(T(r.dirichlet(np.ones(4), size=(2, 3)).astype(np.float32)), tree)
    assert torch.equal(tree["a"], before)


def test_a_refused_launch_with_out_raises_value_error():
    """The aliasing rules live in the C launcher; the wrapper turns its
    refusal (cudaErrorInvalidValue) into a ``ValueError`` naming them when it
    was given ``out=``, and passes a successful launch."""
    kernel._raise_on(0, "gossip_mix_matmul", "aliased")
    with pytest.raises(ValueError, match="launch refused: aliased"):
        kernel._raise_on(kernel._INVALID_VALUE, "gossip_mix_matmul", "aliased")


# the MNIST CNN's eight leaves, flattened: conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b
CNN_WIDTHS = [250, 10, 5000, 20, 16000, 50, 500, 10]


def test_leaf_groups_puts_the_cnn_round_in_one_launch():
    assert kernel.leaf_groups(CNN_WIDTHS, 64) == [list(range(8))]
    assert kernel.leaf_groups(CNN_WIDTHS, 8) == [list(range(8))]


def test_leaf_groups_skips_empty_leaves_and_splits_past_the_table():
    widths = [0] + [1 + 63 * (i % 3) for i in range(130)] + [0, 65]
    groups = kernel.leaf_groups(widths, 64)
    assert [len(ids) for ids in groups] == [64, 64, 3]
    assert [i for ids in groups for i in ids] == list(range(1, 131)) + [132]
    assert kernel.leaf_groups([0, 0], 64) == [] and kernel.leaf_groups([], 64) == []


def test_leaf_groups_keeps_the_leaves_in_order():
    assert kernel.leaf_groups([5] * 5, 2) == [[0, 1], [2, 3], [4]]
    assert kernel.leaf_groups([3, 0, 1, 0, 2], 1) == [[0], [2], [4]]


@pytest.mark.parametrize("k_out,k_in", [(100, 100), (7, 13)])
def test_mix_params_cuda_cpu_route_on_mixed_widths(k_out, k_in):
    """A dictionary of the CNN's leaf widths and a bf16 leaf, square and
    rectangular W: the CPU route matches ``aggregation.mix_params`` leaf by
    leaf and launches nothing."""
    r = np.random.default_rng(k_out)
    w = T(r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32))
    tree = {f"leaf{i}": T(r.normal(size=(k_in, p)).astype(np.float32))
            for i, p in enumerate(CNN_WIDTHS)}
    tree["conv"] = T(r.normal(size=(k_in, 5, 1, 3, 3)).astype(np.float32))
    tree["half"] = T(r.normal(size=(k_in, 33)).astype(np.float32)).to(torch.bfloat16)
    kernel.reset_launch_counts()
    got = mix_params_cuda(w, tree)
    want = aggregation.mix_params(w, tree)
    assert kernel.launch_counts == {"gossip_mix_gather": 0, "gossip_mix_matmul": 0}
    assert list(got) == list(tree)
    for name, x in tree.items():
        assert got[name].shape == (k_out,) + x.shape[1:] and got[name].dtype == x.dtype
        tol = 5e-2 if x.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(_f32(got[name]), _f32(want[name]), atol=tol)


@pytest.mark.parametrize("k_out,k_in,d", [(16, 16, 9), (7, 13, 4)])
def test_grouped_gather_cpu_route_matches_pallas_gather_per_leaf(k_out, k_in, d):
    """The sparse mix of a dictionary of the CNN's leaf widths, a width that
    is not a multiple of 4 and a bf16 leaf, square and rectangular neighbour
    lists: ``mix_params_cuda``'s CPU route (what the grouped gather computes
    on the card) against the reference's Pallas gather in interpret mode,
    leaf by leaf, launching nothing."""
    r = np.random.default_rng(k_out * 10 + d)
    idx = r.integers(0, k_in, size=(k_out, d)).astype(np.int32)
    w = r.random((k_out, d)).astype(np.float32)
    w[:, -1] = 0.0                                   # a zero-weight padding slot
    tree = {f"leaf{i}": r.normal(size=(k_in, p)).astype(np.float32)
            for i, p in enumerate(CNN_WIDTHS + [7])}
    tree["half"] = r.normal(size=(k_in, 33)).astype(np.float32)
    dtypes = {name: jnp.bfloat16 if name == "half" else jnp.float32 for name in tree}
    tree_t = {n: T(x).to(TORCH_DTYPE[dtypes[n]]) for n, x in tree.items()}
    kernel.reset_launch_counts()
    got = mix_params_cuda(contacts.SparseMixing(T(idx), T(w)), tree_t)
    assert kernel.launch_counts == {"gossip_mix_gather": 0, "gossip_mix_matmul": 0}
    for name, x in tree.items():
        want = gossip_mix_gather(jnp.asarray(idx), jnp.asarray(w),
                                 jnp.asarray(x, dtypes[name]), interpret=True)
        assert got[name].shape == (k_out, x.shape[1]) and got[name].dtype == tree_t[name].dtype
        np.testing.assert_allclose(_f32(got[name]), _f32(want), atol=_tol(dtypes[name]))
