"""The port's CUDA kernels on a GPU (marker ``cuda``; skipped where there is
no CUDA device). Imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, f32 atol
1e-5 / bf16 atol 5e-2 (the reference's kernel-test tolerances; flash
attention 2e-5 / 3e-2, its own). Paths that launch them are held card
against CPU: reduced federations, ``serve.generate`` and one DDS train round
(``launch.steps``) of every reduced architecture (1e-4).
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import aggregation, contacts
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed.simulator import SimulationConfig, run_simulation
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHITECTURES, PORT_ONLY
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kl_simplex
from repro_torch.precision import full_f32_matmul
from repro_torch.kernels.gossip_mix import (gossip_mix_gather_ref,
                                            gossip_mix_matmul_grouped,
                                            gossip_mix_matmul_ref, kernel,
                                            mix_params_cuda, mix_params_cuda_)

pytestmark = pytest.mark.cuda

SWEEP = [(7, 7, 33, torch.float32), (16, 16, 512, torch.float32),
         (64, 64, 2048, torch.float32), (100, 100, 700, torch.float32),
         (12, 12, 257, torch.bfloat16), (8, 8, 128, torch.bfloat16),
         (3, 8, 130, torch.float32), (8, 4, 257, torch.bfloat16)]
ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU machine: "
                    "python -m pytest -q -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("k_out,k_in,p,dtype", SWEEP)
def test_matmul_kernel_matches_plain_version(card, k_out, k_in, p, dtype):
    r = np.random.default_rng(k_out * 1000 + p)
    w = torch.as_tensor(r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32)).to(card)
    x = torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype).to(card)
    before = kernel.launch_counts["gossip_mix_matmul"]
    got = kernel.gossip_mix_matmul(w, x)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == before + 1
    assert got.shape == (k_out, p) and got.dtype == dtype
    assert _err(got, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]


@pytest.mark.parametrize("k_out,k_in,p,dtype", SWEEP)
def test_gather_kernel_matches_plain_version(card, k_out, k_in, p, dtype):
    r = np.random.default_rng(9 + k_out + p)
    idx = torch.as_tensor(r.integers(0, k_in, size=(k_out, 5)).astype(np.int32)).to(card)
    w = r.random((k_out, 5)).astype(np.float32)
    w[:, -1] = 0.0
    w = torch.as_tensor(w).to(card)
    x = torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype).to(card)
    before = kernel.launch_counts["gossip_mix_gather"]
    got = kernel.gossip_mix_gather(idx, w, x)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_gather"] == before + 1
    assert got.shape == (k_out, p) and got.dtype == dtype
    assert _err(got, gossip_mix_gather_ref(idx, w, x)) <= ATOL[dtype]


def test_mix_params_cuda_launches_one_kernel_per_mix(card):
    """Dense and sparse: one grouped launch for all the leaves."""
    r = np.random.default_rng(0)
    k = 6
    tree = {"a": torch.as_tensor(r.normal(size=(k, 3, 5)).astype(np.float32)).to(card),
            "b": torch.as_tensor(r.normal(size=(k, 11)).astype(np.float32)).to(card)}
    w = torch.as_tensor(r.dirichlet(np.ones(k), size=k).astype(np.float32)).to(card)
    idx = torch.as_tensor(r.integers(0, k, size=(k, 3)).astype(np.int32)).to(card)
    ws = torch.as_tensor(r.random((k, 3)).astype(np.float32)).to(card)
    for mixing, name, launches in ((w, "gossip_mix_matmul", 1),
                                   (contacts.SparseMixing(idx, ws), "gossip_mix_gather", 1)):
        kernel.reset_launch_counts()
        got = mix_params_cuda(mixing, tree)
        want = aggregation.mix_params(mixing, tree)
        assert kernel.launch_counts[name] == launches
        for n in tree:
            assert got[n].shape == tree[n].shape
            assert _err(got[n], want[n]) <= 1e-5


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.ones(4, 8, device=card)
    with pytest.raises(TypeError):
        kernel.gossip_mix_matmul(torch.eye(4, device=card), x.double())
    with pytest.raises(ValueError):
        kernel.gossip_mix_matmul(torch.eye(5, device=card), x)
    with pytest.raises(ValueError):
        kernel.gossip_mix_matmul(torch.eye(4, device=card), x.t())
    with pytest.raises(ValueError):          # W on another device than the leaves
        kernel.gossip_mix_matmul(torch.eye(4), x)
    with pytest.raises(TypeError):           # one dtype per group
        kernel.gossip_mix_matmul_grouped(torch.eye(4, device=card),
                                         [x, x.to(torch.bfloat16)])
    with pytest.raises(TypeError):
        kernel.gossip_mix_gather(torch.zeros(4, 2, dtype=torch.int64, device=card),
                                 torch.ones(4, 2, device=card), x)
    with pytest.raises(ValueError):
        kernel.gossip_mix_gather(torch.zeros(4, 2, dtype=torch.int32),
                                 torch.ones(4, 2, device=card), x)


# leaf widths of a grouped mix: one column, the CNN's narrow and widest leaves,
# a width that is not a multiple of 4 (rows not 16-byte aligned), one of 250
GROUP_WIDTHS = [1, 10, 250, 16000, 7, 4097]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_out,k_in", [(100, 100), (3, 8), (8, 13), (33, 300)])
def test_grouped_matmul_kernel_matches_plain_version_per_leaf(card, k_out, k_in, dtype):
    """Square and rectangular W, K_in not a multiple of 4 and past one staged
    chunk of 128 rows; one launch for the whole group."""
    r = np.random.default_rng(k_out + k_in)
    w = torch.as_tensor(r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32)).to(card)
    flats = [torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype).to(card)
             for p in GROUP_WIDTHS]
    before = kernel.launch_counts["gossip_mix_matmul"]
    got = gossip_mix_matmul_grouped(w, flats)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == before + 1
    for x, out in zip(flats, got):
        assert out.shape == (k_out, x.shape[1]) and out.dtype == dtype
        assert _err(out, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]


def test_grouped_matmul_splits_a_group_past_the_table(card):
    r = np.random.default_rng(3)
    k = 9
    n = kernel.matmul_max_leaves() + 6
    w = torch.as_tensor(r.dirichlet(np.ones(k), size=k).astype(np.float32)).to(card)
    tree = {f"leaf{i}": torch.as_tensor(r.normal(size=(k, 1 + 37 * i)).astype(np.float32))
            .to(card) for i in range(n)}
    kernel.reset_launch_counts()
    got = mix_params_cuda(w, tree)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == 2
    for name, x in tree.items():
        assert got[name].shape == x.shape
        assert _err(got[name], gossip_mix_matmul_ref(w, x)) <= 1e-5


def _neighbours(k_out, k_in, d, seed, card):
    r = np.random.default_rng(seed)
    idx = torch.as_tensor(r.integers(0, k_in, size=(k_out, d)).astype(np.int32)).to(card)
    w = r.random((k_out, d)).astype(np.float32)
    w[:, -1] = 0.0                                  # a zero-weight padding slot
    return idx, torch.as_tensor(w).to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_out,k_in,d", [(100, 100, 9), (3, 8, 5), (8, 13, 4), (33, 300, 9)])
def test_grouped_gather_kernel_matches_plain_version_per_leaf(card, k_out, k_in, d, dtype):
    """Square and rectangular neighbour lists over leaves of one column, of
    widths not a multiple of the 16-byte vector (element-wise path) and wide
    ones (16-byte path); one launch for the whole group."""
    idx, w = _neighbours(k_out, k_in, d, k_out + k_in, card)
    r = np.random.default_rng(d)
    flats = [torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype).to(card)
             for p in GROUP_WIDTHS]
    before = kernel.launch_counts["gossip_mix_gather"]
    got = kernel.gossip_mix_gather_grouped(idx, w, flats)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_gather"] == before + 1
    for x, out in zip(flats, got):
        assert out.shape == (k_out, x.shape[1]) and out.dtype == dtype
        assert _err(out, gossip_mix_gather_ref(idx, w, x)) <= ATOL[dtype]


def test_grouped_gather_takes_an_unaligned_leaf_beside_aligned_ones(card):
    """A leaf whose rows start 4 bytes past a 16-byte boundary takes the
    element-wise path inside the same launch as the 16-byte leaves."""
    idx, w = _neighbours(9, 9, 4, 1, card)
    r = np.random.default_rng(2)
    x = torch.as_tensor(r.normal(size=(9, 64)).astype(np.float32)).to(card)
    shifted = torch.zeros(9 * 64 + 1, device=card)[1:].view(9, 64)
    shifted.copy_(x)
    flats = [x, shifted, x[:, :60].contiguous()]
    before = kernel.launch_counts["gossip_mix_gather"]
    got = kernel.gossip_mix_gather_grouped(idx, w, flats)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_gather"] == before + 1
    for x_l, out in zip(flats, got):
        assert _err(out, gossip_mix_gather_ref(idx, w, x_l)) <= 1e-5


def test_grouped_gather_splits_a_group_past_the_table(card):
    k = 9
    idx, w = _neighbours(k, k, 4, 3, card)
    r = np.random.default_rng(3)
    n = kernel.gather_max_leaves() + 6
    tree = {f"leaf{i}": torch.as_tensor(r.normal(size=(k, 1 + 37 * i)).astype(np.float32))
            .to(card) for i in range(n)}
    kernel.reset_launch_counts()
    got = mix_params_cuda(contacts.SparseMixing(idx, w), tree)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_gather"] == 2
    for name, x in tree.items():
        assert got[name].shape == x.shape
        assert _err(got[name], gossip_mix_gather_ref(idx, w, x)) <= 1e-5


def test_grouped_gather_raises_on_what_the_kernel_does_not_take(card):
    idx, w = _neighbours(4, 4, 2, 0, card)
    x = torch.ones(4, 8, device=card)
    with pytest.raises(TypeError):           # one dtype per group
        kernel.gossip_mix_gather_grouped(idx, w, [x, x.to(torch.bfloat16)])
    with pytest.raises(ValueError):          # one K_in per group
        kernel.gossip_mix_gather_grouped(idx, w, [x, torch.ones(5, 8, device=card)])
    with pytest.raises(ValueError):          # a leaf on the CPU
        kernel.gossip_mix_gather_grouped(idx, w, [x, torch.ones(4, 8)])
    with pytest.raises(ValueError):          # a strided leaf
        kernel.gossip_mix_gather_grouped(idx, w, [x, torch.ones(8, 4, device=card).t()])
    with pytest.raises(ValueError):          # idx and w differ in shape
        kernel.gossip_mix_gather_grouped(idx, w[:, :1].contiguous(), [x])
    with pytest.raises(TypeError):
        kernel.gossip_mix_gather_grouped(idx, w.double(), [x])
    with pytest.raises(RuntimeError):        # D past the block's slot buffer
        kernel.gossip_mix_gather_grouped(torch.zeros(4, 2000, dtype=torch.int32, device=card),
                                         torch.zeros(4, 2000, device=card), [x])
    assert kernel.gossip_mix_gather_grouped(idx, w, []) == []


@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
def test_small_federation_on_the_card_matches_the_cpu(card, contact_format):
    ds = synthetic_mnist(n_train=1200, n_test=200)
    base = dict(num_vehicles=8, epochs=4, eval_every=2, eval_samples=200,
                local_steps=2, batch_size=16, p1_steps=40, comm_range=250.0,
                num_rsus=1, p_drop=0.1, contact_format=contact_format)
    kernel.reset_launch_counts()
    on_card = run_simulation(SimulationConfig(**base, device="cuda"), dataset=ds)
    # one grouped launch per epoch's mix, gather (sparse) or matmul (dense)
    used = "gossip_mix_gather" if contact_format == "sparse" else "gossip_mix_matmul"
    assert kernel.launch_counts[used] == 4
    on_cpu = run_simulation(SimulationConfig(**base, device="cpu"), dataset=ds)
    np.testing.assert_allclose(on_card.kl_trace, on_cpu.kl_trace, atol=1e-5)
    np.testing.assert_allclose(on_card.comm_mb, on_cpu.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(on_card.entropy), np.stack(on_cpu.entropy), atol=1e-5)


# ------------------------------------------------------------ kl_simplex ----

KL_SHAPES = [(1, 2, torch.float32), (40, 50, torch.float32), (33, 100, torch.float32),
             (100, 101, torch.float32), (64, 1024, torch.float32),
             (8, 4096, torch.float32), (33, 100, torch.bfloat16),
             (64, 1024, torch.bfloat16), (8, 4096, torch.bfloat16)]


def _state_rows(v, k, dtype, seed, card):
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=v).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    return torch.as_tensor(s).to(dtype).to(card), torch.as_tensor(g).to(card)


@pytest.mark.parametrize("v,k,dtype", KL_SHAPES)
def test_row_kernels_match_plain_versions(card, v, k, dtype):
    s, g = _state_rows(v, k, dtype, v + k, card)
    before = dict(kl_simplex.kernel.launch_counts)
    got_kl = kl_simplex.kl_rows(s, g)
    got_h = kl_simplex.entropy_rows(s)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["kl_rows"] == before["kl_rows"] + 1
    assert kl_simplex.kernel.launch_counts["entropy_rows"] == before["entropy_rows"] + 1
    assert got_kl.shape == got_h.shape == (v,) and got_kl.dtype == torch.float32
    assert _err(got_kl, kl_simplex.kl_rows_ref(s, g)) <= ATOL[dtype]
    assert _err(got_h, kl_simplex.entropy_rows_ref(s)) <= ATOL[dtype]


def _row_edge_case(name, card):
    """(states, target, dtype) of one edge case of the row kernels' paths:
    K off the 16-byte loads, bases off a 16-byte boundary, g staged in
    chunks, a single element, a one-hot row beside an RSU row (all zero, with
    a zero target entry)."""
    f32, bf16 = torch.float32, torch.bfloat16
    if name in ("ragged_f32", "ragged_bf16"):               # K % 4, K % 8 != 0
        dtype = f32 if name == "ragged_f32" else bf16
        return (*_state_rows(37, 203, dtype, 203, card), dtype)
    if name in ("row_slice_f32", "row_slice_bf16"):         # s[1:] of [V, 101]
        dtype = f32 if name == "row_slice_f32" else bf16
        s, g = _state_rows(9, 101, dtype, 101, card)
        return s[1:], g, dtype
    if name == "offset_base_f32":                           # K % 4 == 0, base 4 B off
        s, g = _state_rows(9, 64, f32, 64, card)
        flat = torch.empty(9 * 64 + 1, device=card)
        flat[1:] = s.reshape(-1)
        return flat[1:].view(9, 64), g, f32
    if name in ("chunked_f32", "chunked_bf16"):             # g staged in 8 chunks
        dtype = f32 if name == "chunked_f32" else bf16
        return (*_state_rows(4, 65536, dtype, 4, card), dtype)
    if name == "single":                                    # V = K = 1
        return torch.full((1, 1), 0.75, device=card), torch.ones(1, device=card), f32
    if name == "one_hot_and_rsu":
        s, g = _state_rows(6, 100, f32, 6, card)
        s[2] = 0.0
        s[2, 37] = 1.0
        s[5] = 0.0
        g[99] = 0.0
        return s, g, f32
    raise KeyError(name)


ROW_EDGE_CASES = ["ragged_f32", "ragged_bf16", "row_slice_f32", "row_slice_bf16",
                  "offset_base_f32", "chunked_f32", "chunked_bf16", "single",
                  "one_hot_and_rsu"]


@pytest.mark.parametrize("name", ROW_EDGE_CASES)
def test_row_kernels_match_plain_versions_on_every_path(card, name):
    s, g, dtype = _row_edge_case(name, card)
    assert s.is_contiguous()
    before = dict(kl_simplex.kernel.launch_counts)
    got_kl = kl_simplex.kl_rows(s, g)
    got_h = kl_simplex.entropy_rows(s)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["kl_rows"] == before["kl_rows"] + 1
    assert kl_simplex.kernel.launch_counts["entropy_rows"] == before["entropy_rows"] + 1
    assert got_kl.shape == got_h.shape == (s.shape[0],)
    assert _err(got_kl, kl_simplex.kl_rows_ref(s, g)) <= ATOL[dtype]
    assert _err(got_h, kl_simplex.entropy_rows_ref(s)) <= ATOL[dtype]
    if name == "one_hot_and_rsu":
        assert float(got_h[2]) == 0.0 and float(got_h[5]) == 0.0 and float(got_kl[5]) == 0.0


def _row_mapping(s, sms):
    """(16-byte loads, rows per block, warps per row): the mapping
    ``csrc/row_stream.cuh``'s ``pick_mapping`` takes for the states ``s`` on a
    card of ``sms`` SMs, mirrored to choose the shapes below."""
    v, k = s.shape
    n = 4 if s.dtype == torch.float32 else 8
    vec = s.data_ptr() % 16 == 0 and k % n == 0 and k // n >= 32
    packs = k // n if vec else k
    p = 1
    while p < 16 and 32 * 16 * p < k:                 # at most 16 elements a thread
        p *= 2
    while p < 16 and 64 * p <= packs and v * p < 4 * sms:   # too few rows to fill the card
        p *= 2
    r = 1
    while 2 * r * p <= 16 and -(-v // (2 * r)) >= sms:    # every SM keeps a block
        r *= 2
    return int(vec), r, p


def _mapping_case(name, sms):
    """(V, K, dtype) of a shape that takes one branch of the launcher's
    mapping; the mapping on 132 SMs in the comment."""
    f32, bf16 = torch.float32, torch.bfloat16
    if name.startswith("rows_"):                      # (1, r, 1): V = r x SMs, K = 128
        return int(name[5:]) * sms, 128, f32
    return {"one_element": (1, 1, f32),               # (0, 1, 1)
            "short_rows": (100, 100, f32),            # (0, 1, 2): 25 loads, 2 warps to fill
            "ragged_rows": (37, 203, bf16),           # (0, 1, 4): 4-byte loads, 4 warps to fill
            "k_1024": (1024, 1024, f32),              # (1, 4, 2): 2 warps for 1,024 columns
            "k_2048": (200, 2048, f32),               # (1, 1, 4)
            "k_4096": (300, 4096, bf16),              # (1, 2, 8)
            "few_long_rows": (64, 4096, f32),         # (1, 1, 16): 8 warps by K, 16 to fill
            "longest_rows": (2, 20000, f32),          # (1, 1, 16): by K, g in 3 chunks
            }[name]


ROW_MAPPING_CASES = ["one_element", "short_rows", "ragged_rows", "k_1024", "k_2048", "k_4096",
                     "few_long_rows", "longest_rows", "rows_2", "rows_4", "rows_8", "rows_16"]


@pytest.mark.parametrize("name", ROW_MAPPING_CASES)
def test_row_kernels_match_plain_versions_at_each_mapping(card, name):
    """One shape per branch of the launcher's mapping, against the plain
    versions: rows past V in the last block, threads past a row's end,
    teams of 2-16 warps, g in chunks."""
    v, k, dtype = _mapping_case(name, torch.cuda.get_device_properties(card).multi_processor_count)
    s, g = _state_rows(v, k, dtype, v + k, card)
    got_kl = kl_simplex.kl_rows(s, g)
    got_h = kl_simplex.entropy_rows(s)
    torch.cuda.synchronize()
    assert _err(got_kl, kl_simplex.kl_rows_ref(s, g)) <= ATOL[dtype]
    assert _err(got_h, kl_simplex.entropy_rows_ref(s)) <= ATOL[dtype]


def test_row_mapping_cases_reach_every_branch(card):
    """The cases above take both load widths and every rows per block and
    warps per row the launcher can pick on this card."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    picked = []
    for name in ROW_MAPPING_CASES:
        v, k, dtype = _mapping_case(name, sms)
        picked.append(_row_mapping(torch.empty((v, k), dtype=dtype, device=card), sms))
    assert {m[0] for m in picked} == {0, 1}
    assert {m[1] for m in picked} == {m[2] for m in picked} == {1, 2, 4, 8, 16}


@pytest.mark.parametrize("v,k,dtype", [(4, 8, torch.float32), (33, 100, torch.float32),
                                       (128, 16, torch.float32), (100, 100, torch.float32),
                                       (64, 1024, torch.float32), (8, 4096, torch.float32),
                                       (16, 200, torch.bfloat16)])
def test_eg_step_kernel_matches_plain_version(card, v, k, dtype):
    r = np.random.default_rng(v * k)
    m = (r.random((v, k)) < 0.5).astype(np.float32)
    m[:, 0] = 1.0
    a = r.dirichlet(np.ones(k), size=v).astype(np.float32) * m
    a = a / a.sum(1, keepdims=True)
    grad = r.normal(size=(v, k)).astype(np.float32)
    a, grad, m = (torch.as_tensor(x).to(dtype).to(card) for x in (a, grad, m))
    before = kl_simplex.kernel.launch_counts["eg_step"]
    got = kl_simplex.eg_step(a, grad, m, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_step"] == before + 1
    assert got.shape == (v, k) and got.dtype == torch.float32
    assert _err(got, kl_simplex.eg_step_ref(a, grad, m, step_size=2.0)) <= ATOL[dtype]
    assert bool((got[m == 0] == 0).all())


def test_eg_step_kernel_gives_zero_on_an_empty_mask_row(card):
    for k in (6, 2000):                       # register and streaming variants
        a = torch.full((3, k), 1.0 / k, device=card)
        grad = torch.randn(3, k, device=card)
        m = torch.ones(3, k, device=card)
        m[1] = 0.0
        got = kl_simplex.eg_step(a, grad, m)
        torch.cuda.synchronize()
        assert bool((got[1] == 0).all()) and bool(torch.isfinite(got).all())
        assert torch.allclose(got[[0, 2]].sum(1), torch.ones(2, device=card), atol=1e-5)


def test_kl_simplex_wrappers_raise_on_what_the_kernels_do_not_take(card):
    s = torch.rand(4, 8, device=card)
    g = torch.rand(8, device=card)
    with pytest.raises(TypeError):
        kl_simplex.kl_rows_kernel(s.double(), g)
    with pytest.raises(TypeError):
        kl_simplex.kl_rows_kernel(s, g.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kl_simplex.kl_rows_kernel(s, torch.rand(7, device=card))
    with pytest.raises(ValueError):
        kl_simplex.entropy_rows_kernel(s.t())
    with pytest.raises(ValueError):
        kl_simplex.entropy_rows_kernel(torch.rand(8, device=card))
    with pytest.raises(TypeError):
        kl_simplex.eg_step(s, s, s.to(torch.bfloat16))
    with pytest.raises(ValueError):
        kl_simplex.eg_step(s, s, torch.rand(4, 9, device=card))
    with pytest.raises(ValueError):
        kl_simplex.eg_step(s, s.cpu(), s)


def test_fused_p1_solver_on_the_card_matches_the_cpu(card):
    from repro_torch.core import kl_solver
    r = np.random.default_rng(9)
    k = 100
    s = torch.as_tensor(r.dirichlet(np.ones(k), size=k).astype(np.float32))
    g = torch.as_tensor(r.dirichlet(np.ones(k) * 2).astype(np.float32))
    c = torch.as_tensor(np.minimum((r.random((k, k)) < 0.1) + (r.random((k, k)) < 0.1).T
                                   + np.eye(k), 1).astype(np.float32))
    kl_simplex.kernel.reset_launch_counts()
    on_card = kl_solver.solve_p1_all(s.to(card), g.to(card), c.to(card),
                                     num_steps=200, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_solve"] == 1
    assert kl_simplex.kernel.launch_counts["eg_step"] == 0
    on_cpu = kl_solver.solve_p1_all(s, g, c, num_steps=200, step_size=2.0)
    assert _err(on_card.cpu(), on_cpu) <= 1e-5
    assert bool((on_card.cpu()[c == 0] == 0).all())
    obj = kl_solver.kl_objective(on_card.cpu(), s, g)
    assert _err(obj, kl_solver.kl_objective(on_cpu, s, g)) <= 1e-5


def _p1_case(v, k, seed, card, empty_row=True):
    """States [V, K], a target, a 0/1 contact matrix [V, V] with a self
    contact on every row but row 1, which has no contact at all."""
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=v).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    c = np.minimum((r.random((v, v)) < 0.1) + (r.random((v, v)) < 0.1).T + np.eye(v),
                   1).astype(np.float32)
    if empty_row:
        c[1] = 0.0
    return tuple(torch.as_tensor(x).to(card) for x in (s, g, c))


@pytest.mark.parametrize("num_steps", [1, 200])
@pytest.mark.parametrize("k", [8, 100, "limit"])
def test_eg_solve_kernel_matches_plain_version(card, k, num_steps):
    """The whole solve in one launch on dense contacts (no id table) against
    its plain version at V = K = 8, 100 and the library's limit, one and 200
    steps: f32 atol 1e-5, exactly 0 off the contacts and on the row with
    none."""
    k = kl_simplex.kernel.eg_solve_max_k() if k == "limit" else k
    s, g, c = _p1_case(k, k, k + num_steps, card)
    before = dict(kl_simplex.kernel.launch_counts)
    got = kl_simplex.eg_solve_rows(s, None, g, c, num_steps=num_steps, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_solve"] == before["eg_solve"] + 1
    assert kl_simplex.kernel.launch_counts["eg_step"] == before["eg_step"]
    want = kl_simplex.eg_solve_rows_ref(s, None, g, c, num_steps=num_steps, step_size=2.0)
    assert got.shape == (k, k) and got.dtype == torch.float32
    assert _err(got, want) <= 1e-5
    assert bool((got[c == 0] == 0).all()) and bool((got[1] == 0).all())
    rows = got.sum(1)[c.sum(1) > 0]
    assert torch.allclose(rows, torch.ones_like(rows), atol=1e-5)


def test_eg_solve_kernel_on_rectangular_and_unaligned_states(card):
    """States [D, K] with K not a multiple of 4 (scalar staging), K < D and
    K > D, a mask of another row count than D."""
    r = np.random.default_rng(4)
    for d, k, rows in ((30, 7, 30), (12, 97, 5), (64, 33, 100)):
        s = torch.as_tensor(r.dirichlet(np.ones(k), size=d).astype(np.float32)).to(card)
        g = torch.as_tensor(r.dirichlet(np.ones(k)).astype(np.float32)).to(card)
        m = torch.as_tensor((r.random((rows, d)) < 0.4).astype(np.float32)).to(card)
        got = kl_simplex.eg_solve_rows(s, None, g, m, num_steps=50)
        want = kl_simplex.eg_solve_rows_ref(s, None, g, m, num_steps=50)
        torch.cuda.synchronize()
        assert got.shape == (rows, d)
        assert _err(got, want) <= 1e-5 and bool((got[m == 0] == 0).all())


def test_p1_solve_past_the_limit_takes_the_per_step_loop(card):
    """K = 300 does not fit one block: ``eg_solve_rows`` raises, and
    ``solve_p1_all`` takes one ``eg_step`` launch per step, held to the same
    checks and to the plain loop on the CPU."""
    from repro_torch.core import kl_solver
    k = 300
    assert not kl_simplex.kernel.eg_solve_fits(k, k)
    assert kl_simplex.kernel.eg_solve_fits(100, 100)
    s, g, c = _p1_case(k, k, 5, card, empty_row=False)
    with pytest.raises(ValueError, match="do not fit"):
        kl_simplex.eg_solve_rows(s, None, g, c, num_steps=40)
    kl_simplex.kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    alpha = kl_solver.solve_p1_all(s, g, c, num_steps=40, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_step"] == 40
    assert kl_simplex.kernel.launch_counts["eg_solve"] == 0
    assert kl_solver.solve_counts == {"kernel": 0, "eager": 1}
    assert _err(alpha, kl_simplex.eg_solve_rows_ref(s, None, g, c, num_steps=40)) <= 1e-5
    assert bool((alpha[c == 0] == 0).all())
    rows = alpha.sum(1)
    assert torch.allclose(rows, torch.ones_like(rows), atol=1e-5)
    plain = kl_solver.solve_p1_all(s.cpu(), g.cpu(), c.cpu(), num_steps=40, step_size=2.0)
    assert _err(kl_solver.kl_objective(alpha.cpu(), s.cpu(), g.cpu()),
                kl_solver.kl_objective(plain, s.cpu(), g.cpu())) <= 1e-5


def test_eg_solve_wrapper_raises_on_what_the_kernel_does_not_take(card):
    """Dense contacts (no id table) on what the kernel does not take."""
    s, g, c = _p1_case(8, 8, 0, card)
    with pytest.raises(TypeError):
        kl_simplex.eg_solve_rows(s.to(torch.bfloat16), None, g, c, num_steps=2)
    with pytest.raises(TypeError):
        kl_simplex.eg_solve_rows(s, None, g.double(), c, num_steps=2)
    with pytest.raises(ValueError):           # target of the wrong length
        kl_simplex.eg_solve_rows(s, None, g[:7].contiguous(), c, num_steps=2)
    with pytest.raises(ValueError):           # more mask columns than rows of states
        kl_simplex.eg_solve_rows(s, None, g, torch.ones(8, 9, device=card), num_steps=2)
    with pytest.raises(ValueError):
        kl_simplex.eg_solve_rows(s, None, g, c.t(), num_steps=2)
    with pytest.raises(ValueError):
        kl_simplex.eg_solve_rows(s, None, g.cpu(), c, num_steps=2)
    with pytest.raises(ValueError):
        kl_simplex.eg_solve_rows(s, None, g, c, num_steps=-1)
    with pytest.raises(ValueError):
        kl_simplex.eg_solve_rows(s, None, g, c, num_steps=2, step_size=float("nan"))


# ------------------------------------ the P1 solve on the main path ----

@functools.lru_cache(maxsize=None)
def _stream_epoch(seed):
    """Epoch 0 of a real contact stream at the paper's settings (K = 100,
    grid, Manhattan mobility, 100 m, 50 epochs: the benchmark's federation),
    D_max from the stream's own probe: numpy ids / mask ``[K, D_max]``."""
    from repro_torch.fed import engine, topology
    cfg = SimulationConfig(epochs=50, device="cpu", seed=seed)
    window = engine.ContactStream(cfg, topology.make_road_network(cfg.road_net,
                                                                  seed=cfg.seed)).window(1)
    return contacts.SparseContacts(window.idx[0], window.mask[0])


def _random_states(shape, seed, card):
    r = np.random.default_rng(seed)
    k = shape[-1]
    s = r.dirichlet(np.ones(k) * 0.5, size=shape[:-1]).astype(np.float32)
    s[..., r.integers(0, k)] = 0.0                  # a data source nobody holds
    g = r.dirichlet(np.ones(k) * 2, size=shape[:-2]).astype(np.float32)
    return (torch.as_tensor(s / s.sum(-1, keepdims=True)).to(card),
            torch.as_tensor(g).to(card))


def _random_neighbours(k, d, seed, card, empty_row=False):
    """Neighbour lists ``[K, d]``: self in slot 0, up to d - 1 others, the
    rest padding (own id, mask 0); with ``empty_row``, row 1 has no slot."""
    r = np.random.default_rng(seed)
    idx = np.repeat(np.arange(k, dtype=np.int32)[:, None], d, axis=1)
    mask = np.zeros((k, d), np.float32)
    mask[:, 0] = 1.0
    for v in range(k):
        others = [u for u in r.choice(k, size=int(r.integers(0, d)), replace=False) if u != v]
        idx[v, 1:1 + len(others)] = others
        mask[v, 1:1 + len(others)] = 1.0
    if empty_row:
        mask[1] = 0.0
    return torch.as_tensor(idx).to(card), torch.as_tensor(mask).to(card)


def _p1_rows_case(name, card):
    """(states, ids, target, mask, steps) of the id-table form at the shapes
    the main path takes: the K = 100 neighbour lists of a
    real contact stream, 8 such streams on a seed axis (800 rows), a sparse
    K = 1,024, V = 2 dense (identity ids), and rows with padding slots and an
    empty mask."""
    if name == "k100_stream":
        sc = _stream_epoch(0)
        s, g = _random_states((100, 100), 1, card)
        return s, torch.as_tensor(sc.idx).to(card), g, torch.as_tensor(sc.mask).to(card), 200
    if name == "k100_stream_seeds8":
        sc = contacts.stack_windows([contacts.SparseContacts(w.idx[None], w.mask[None])
                                     for w in map(_stream_epoch, range(8))])
        s, g = _random_states((8, 100, 100), 2, card)
        return (s, torch.as_tensor(sc.idx[:, 0]).to(card), g,
                torch.as_tensor(sc.mask[:, 0]).to(card), 200)
    if name == "k1024_sparse":
        s, g = _random_states((1024, 1024), 3, card)
        ids, mask = _random_neighbours(1024, 24, 3, card)
        return s, ids, g, mask, 200
    if name == "v2_dense":
        s, g = _random_states((2, 2), 4, card)
        return s, None, g, torch.ones(2, 2, device=card), 100
    s, g = _random_states((20, 20), 5, card)
    ids, mask = _random_neighbours(20, 8, 5, card, empty_row=True)
    return s, ids, g, mask, 200


P1_ROWS_CASES = ["k100_stream", "k100_stream_seeds8", "k1024_sparse", "v2_dense",
                 "padding_and_empty_row"]


def _eager_p1(states, ids, target, mask, steps):
    """The loop route of ``solve_p1_all`` (over the ``eg_step`` kernel on the
    card) on the same layout."""
    from repro_torch.core import kl_solver
    layout = mask if ids is None else contacts.SparseContacts(ids, mask)
    return kl_solver._solve_p1_loop(states, target, layout, steps, 2.0)


@pytest.mark.parametrize("name", P1_ROWS_CASES)
def test_eg_solve_rows_matches_the_eager_solve_and_its_plain_version(card, name):
    """The id-table form in one launch against its plain version and against
    the loop route of ``solve_p1_all`` (``ref.eg_iterate`` over the
    ``eg_step`` kernel), f32 atol 1e-6: exactly 0 on padding and on a row
    with no contact, rows on the simplex."""
    states, ids, target, mask, steps = _p1_rows_case(name, card)
    before = dict(kl_simplex.kernel.launch_counts)
    got = kl_simplex.eg_solve_rows(states, ids, target, mask, num_steps=steps, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_solve"] == before["eg_solve"] + 1
    assert kl_simplex.kernel.launch_counts["eg_step"] == before["eg_step"]
    assert got.shape == mask.shape and got.dtype == torch.float32
    with full_f32_matmul():
        want = kl_simplex.eg_solve_rows_ref(states, ids, target, mask, num_steps=steps,
                                            step_size=2.0)
        eager = _eager_p1(states, ids, target, mask, steps)
    assert _err(got, want) <= 1e-6
    live = mask.sum(-1) > 0
    assert _err(got[live], eager[live]) <= 1e-6
    assert bool((got[mask == 0] == 0).all()) and bool((got[~live] == 0).all())
    rows = got.sum(-1)[live]
    assert torch.allclose(rows, torch.ones_like(rows), atol=1e-5)


@pytest.mark.parametrize("layout", ["sparse", "sparse_seeds", "dense", "dense_seeds", "v2_dense"])
def test_solve_p1_all_on_the_card_is_one_eg_solve_launch(card, layout):
    """``solve_p1_all`` on CUDA tensors at every layout the main path hands it:
    one ``eg_solve`` launch, one kernel solve and no eager one by the
    counters, alpha within 1e-6 of the loop route."""
    from repro_torch.core import kl_solver
    if layout in ("sparse", "sparse_seeds"):
        name = "k100_stream" if layout == "sparse" else "k100_stream_seeds8"
        states, ids, target, mask, steps = _p1_rows_case(name, card)
        arg = contacts.SparseContacts(ids, mask)
    elif layout == "v2_dense":
        states, _, target, arg, steps = _p1_rows_case("v2_dense", card)
    else:
        seeds = 3 if layout == "dense_seeds" else 1
        states, target = _random_states((seeds, 100, 100), 6, card)
        arg = (torch.rand(seeds, 100, 100, generator=torch.Generator().manual_seed(6)) < 0.1)
        arg = (arg | torch.eye(100, dtype=torch.bool)).to(torch.float32).to(card)
        if seeds == 1:
            states, target, arg = states[0], target[0], arg[0]
        steps = 200
    kl_simplex.kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    got = kl_solver.solve_p1_all(states, target, arg, num_steps=steps, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_solver.solve_counts == {"kernel": 1, "eager": 0}
    assert kl_simplex.kernel.launch_counts["eg_solve"] == 1
    assert kl_simplex.kernel.launch_counts["eg_step"] == 0
    with full_f32_matmul():
        eager = kl_solver._solve_p1_loop(states, target, arg, steps, 2.0)
    assert got.shape == eager.shape and _err(got, eager) <= 1e-6


def test_a_sparse_dds_round_is_one_eg_solve_launch_and_no_eager_solve(card):
    """A sparse federation on the card: each epoch's ``dds_round`` solves P1
    in exactly one ``eg_solve`` launch, and no solve takes the eager loop."""
    from repro_torch.core import kl_solver
    ds = synthetic_mnist(n_train=1200, n_test=200)
    cfg = SimulationConfig(num_vehicles=8, epochs=3, eval_every=3, eval_samples=200,
                           local_steps=2, batch_size=16, p1_steps=40, comm_range=250.0,
                           contact_format="sparse", device="cuda")
    kl_simplex.kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    run_simulation(cfg, dataset=ds)
    torch.cuda.synchronize()
    assert kl_simplex.kernel.launch_counts["eg_solve"] == cfg.epochs
    assert kl_solver.solve_counts == {"kernel": cfg.epochs, "eager": 0}


@pytest.mark.parametrize("layout", ["sparse_k1024_d64", "dense_k300"])
def test_a_shape_past_one_block_still_takes_the_eager_loop(card, layout):
    """States per row that do not fit one block of ``eg_solve`` (64 neighbour
    slots at K = 1,024; a dense K = 300) take the loop: no launch of the
    one-launch kernel, one eager solve, one ``eg_step`` launch per step and
    row block of ``P1_BLOCK`` vehicles."""
    from repro_torch.core import kl_solver
    k, d = (1024, 64) if layout == "sparse_k1024_d64" else (300, 300)
    assert not kl_simplex.kernel.eg_solve_fits(d, k)
    states, target = _random_states((k, k), 7, card)
    if layout == "dense_k300":
        arg = torch.ones(k, k, device=card)
    else:
        arg = contacts.SparseContacts(*_random_neighbours(k, d, 7, card))
    kl_simplex.kernel.reset_launch_counts()
    kl_solver.reset_solve_counts()
    alpha = kl_solver.solve_p1_all(states, target, arg, num_steps=20, step_size=2.0)
    torch.cuda.synchronize()
    assert kl_solver.solve_counts == {"kernel": 0, "eager": 1}
    assert kl_simplex.kernel.launch_counts["eg_solve"] == 0
    blocks = -(-k // kl_solver.P1_BLOCK) if layout == "sparse_k1024_d64" else 1
    assert kl_simplex.kernel.launch_counts["eg_step"] == 20 * blocks
    rows = alpha.sum(-1)
    assert torch.allclose(rows, torch.ones_like(rows), atol=1e-5)


def test_the_cost_models_block_mirror_equals_the_library(card):
    """``roofline.scenario_cost.eg_solve_block_bytes`` and ``eg_solve_waves``
    agree with the library's own shared-memory size and fit test."""
    from repro_torch.roofline import scenario_cost as sc
    for d, k in ((1, 1), (2, 2), (11, 100), (100, 100), (234, 234), (235, 235), (7, 30),
                 (24, 1024), (46, 1024), (47, 1024), (33, 97), (300, 300)):
        assert sc.eg_solve_block_bytes(d, k) == kl_simplex.kernel.eg_solve_smem_bytes(d, k)
        assert (sc.eg_solve_waves(k, d) is not None) == kl_simplex.kernel.eg_solve_fits(d, k)


def test_eg_solve_rows_wrapper_raises_on_what_the_kernel_does_not_take(card):
    s, g = _random_states((2, 12, 12), 8, card)
    ids, mask = _random_neighbours(12, 5, 8, card)
    ids, mask = ids.expand(2, 12, 5).contiguous(), mask.expand(2, 12, 5).contiguous()
    ok = kl_simplex.eg_solve_rows(s, ids, g, mask, num_steps=3)
    assert ok.shape == (2, 12, 5)
    for bad, err in ((lambda: kl_simplex.eg_solve_rows(s, ids.long(), g, mask, num_steps=3),
                      TypeError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids, g.double(), mask, num_steps=3),
                      TypeError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids[:, :, :4].contiguous(), g, mask,
                                                       num_steps=3), ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids, g[:1].contiguous(), mask,
                                                       num_steps=3), ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids.transpose(1, 2), g,
                                                       mask.transpose(1, 2), num_steps=3),
                      ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids, g.cpu(), mask, num_steps=3),
                      ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s[0], ids, g[0], mask, num_steps=3),
                      ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s, ids, g, mask, num_steps=-1),
                      ValueError),
                     (lambda: kl_simplex.eg_solve_rows(s[:, :4].contiguous(), None, g, mask,
                                                       num_steps=3), ValueError)):
        with pytest.raises(err):
            bad()


def test_sp_run_on_the_card_matches_the_cpu(card):
    ds = synthetic_mnist(n_train=1200, n_test=200)
    base = dict(algorithm="sp", num_vehicles=8, epochs=3, eval_every=3, eval_samples=200,
                comm_range=250.0, num_rsus=1, p_drop=0.1)
    kernel.reset_launch_counts()
    on_card = run_simulation(SimulationConfig(**base, device="cuda"), dataset=ds)
    assert kernel.launch_counts["gossip_mix_gather"] == 3
    on_cpu = run_simulation(SimulationConfig(**base, device="cpu"), dataset=ds)
    np.testing.assert_allclose(on_card.kl_trace, on_cpu.kl_trace, atol=1e-5)
    np.testing.assert_allclose(on_card.comm_mb, on_cpu.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(on_card.entropy), np.stack(on_cpu.entropy), atol=1e-5)
    assert np.isfinite(on_card.avg_accuracy).all()


# ------------------------------------------------------- flash attention ----

FA_SWEEP = [(2, 64, 4, 4, 32, True, None, torch.float32),
            (1, 100, 8, 2, 64, True, None, torch.float32),
            (2, 33, 4, 1, 16, True, None, torch.float32),
            (1, 128, 4, 4, 64, True, 32, torch.float32),
            (1, 96, 2, 2, 128, False, None, torch.float32),
            (2, 64, 4, 4, 64, True, None, torch.bfloat16),
            (1, 257, 2, 1, 64, True, 100, torch.float32)]
FA_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _qkv(b, s, h, kv, hd, dtype, seed, card, t=None):
    r = np.random.default_rng(seed)
    t = s if t is None else t
    return tuple(torch.as_tensor(r.normal(size=sh).astype(np.float32)).to(dtype).to(card)
                 for sh in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,dtype", FA_SWEEP)
def test_flash_attention_kernel_matches_plain_version(card, b, s, h, kv, hd, causal, win,
                                                       dtype):
    q, k, v = _qkv(b, s, h, kv, hd, dtype, s * h, card)
    before = fa.kernel.launch_counts["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa.kernel.launch_counts["flash_attention"] == before + 1
    assert got.shape == (b, s, h, hd) and got.dtype == dtype
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=win)
    assert _err(got, want) <= FA_ATOL[dtype]
    assert _err(fa.attend(q, k, v, causal=causal, window=win), want) <= FA_ATOL[dtype]


def test_flash_attention_at_a_serving_shape_and_other_lengths(card):
    for b, s, t, causal, win, hd in ((1, 2048, 2048, True, None, 128),
                                     (1, 2048, 2048, True, 512, 128),
                                     (2, 72, 40, False, 40, 64), (2, 40, 72, False, None, 32)):
        q, k, v = _qkv(b, s, 16 if hd == 128 else 4, 8 if hd == 128 else 2, hd,
                       torch.float32, s + t, card, t=t)
        got = fa.flash_attention(q, k, v, causal=causal, window=win, scale=0.3)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=win, scale=0.3)
        assert _err(got, want) <= 2e-5
    # bf16 at the serving shape: within one bf16 rounding step (2**-7 < 1e-2) of
    # each value above the f32 tolerance, far inside the sweep's 3e-2
    q, k, v = _qkv(1, 2048, 16, 8, 128, torch.bfloat16, 9, card)
    got = fa.flash_attention(q, k, v).float()
    want = fa.flash_attention_ref(q, k, v).float()
    assert bool(((got - want).abs() <= 2e-5 + 1e-2 * want.abs()).all())


def test_flash_attention_gives_zero_on_a_row_with_no_key(card):
    q, k, v = _qkv(1, 100, 2, 1, 64, torch.float32, 3, card, t=10)
    got = fa.flash_attention(q, k, v, causal=False, window=5)
    want = fa.flash_attention_ref(q, k, v, causal=False, window=5)
    torch.cuda.synchronize()
    assert bool((got[:, 14:] == 0).all()) and bool(torch.isnan(want[:, 14:]).all())
    assert _err(got[:, :14], want[:, :14]) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2), (6, 2)])
def test_flash_attention_kernel_over_gqa_groups(card, h, kv, dtype):
    """G = 1, 2, 4 (one or two q-heads per block, a group split over blocks)
    and G = 3 (odd: one head per block), causal with a ragged S."""
    q, k, v = _qkv(2, 150, h, kv, 64, dtype, h * 10 + kv, card)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _err(got, fa.flash_attention_ref(q, k, v)) <= FA_ATOL[dtype]


def test_flash_attention_wrapper_raises_on_a_misaligned_view(card):
    """The kernel copies rows 16 bytes at a time: a view whose rows do not
    start on a 16-byte boundary raises, and is not copied in silence."""
    q, k, v = _qkv(1, 16, 4, 2, 32, torch.float32, 0, card)
    shifted = torch.zeros(1, 16, 4, 33, device=card)[..., 1:]     # 4 bytes past
    assert shifted.stride(-1) == 1
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(shifted, k, v)
    odd_rows = torch.zeros(1, 16, 2, 34, device=card)[..., :32]   # rows 136 bytes apart
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, odd_rows, v)
    launches = fa.kernel.launch_counts["flash_attention"]
    aligned = torch.zeros(1, 16, 4, 36, device=card)[..., 4:]    # 16 bytes past
    aligned.copy_(q)
    assert _err(fa.flash_attention(aligned, k, v), fa.flash_attention_ref(q, k, v)) <= 2e-5
    assert fa.kernel.launch_counts["flash_attention"] == launches + 1


def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(1, 16, 4, 2, 32, torch.float32, 0, card)
    with pytest.raises(ValueError):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        fa.flash_attention(*_qkv(1, 16, 3, 2, 32, torch.float32, 0, card))
    with pytest.raises(ValueError):
        fa.flash_attention(*_qkv(1, 16, 2, 2, 256, torch.float32, 0, card))
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))


def test_reduced_prefill_through_the_kernel_matches_the_plain_path(card):
    from repro_torch.models import transformer
    cfg = get_config("qwen3-1.7b").reduced()
    params = transformer.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=card,
                           generator=torch.Generator(device=card).manual_seed(1))
    fa.kernel.reset_launch_counts()
    got, state = transformer.prefill(params, tokens, cfg, attn_impl=fa.make_attn_impl(),
                                     cache_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.kernel.launch_counts["flash_attention"] == cfg.num_layers
    want, plain_state = transformer.prefill(params, tokens, cfg, cache_dtype=torch.float32)
    assert _err(got, want) <= 1e-4
    assert _err(state.kv.k, plain_state.kv.k) <= 1e-4


# flash attention at the zoo's prefill shapes (f32): hd=64 with G=1 (musicgen 32/32)
# and G=5 (hymba 25/5, one q-head per block), hd=128 with G=6 (internvl2 48/8),
# mixtral's 4,096 window past its edge, and sequences that start with a frontend
# prefix (64 / 256 positions before the prompt: one causal sequence)
ZOO_FA = [(2, 300, 32, 32, 64, None), (2, 300, 25, 5, 64, None), (1, 300, 48, 8, 128, None),
          (1, 4200, 32, 8, 128, 4096), (2, 64 + 200, 32, 32, 64, None),
          (1, 256 + 200, 48, 8, 128, None)]
ZOO_ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b", "rwkv6-3b", "hymba-1.5b",
             "internvl2-26b", "musicgen-large"]


@pytest.mark.parametrize("b,s,h,kv,hd,win", ZOO_FA)
def test_flash_attention_at_the_zoo_shapes(card, b, s, h, kv, hd, win):
    q, k, v = _qkv(b, s, h, kv, hd, torch.float32, s + h, card)
    got = fa.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert _err(got, fa.flash_attention_ref(q, k, v, window=win)) <= FA_ATOL[torch.float32]


@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_reduced_generate_on_the_card_matches_the_cpu(card, arch):
    """``serve.generate`` of a reduced config (70 prompt tokens: past
    mixtral's reduced window of 64) on the card against the CPU, the same
    weights and inputs: one kernel launch per attention layer (none for
    rwkv6), the same greedy tokens, logits to 1e-4."""
    from repro_torch import convert
    from repro_torch.launch import serve
    from repro_torch.models import multimodal, transformer
    cfg = get_config(arch).reduced()
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.true_vocab_size, (2, 70), generator=gen)
    prefix = None
    if cfg.embed_input:
        raw = torch.randn((2, cfg.frontend_tokens, multimodal.frontend_feature_dim(cfg)),
                          generator=gen)
        prefix = multimodal.frontend_embeddings(cfg, raw)
    impl = fa.make_attn_impl(window=cfg.sliding_window)
    want = serve.generate(params, tokens, cfg, gen=6, attn_impl=impl, prefix_embeds=prefix)
    fa.kernel.reset_launch_counts()
    got = serve.generate(convert.transformer_params_from_numpy(params, card), tokens.to(card),
                         cfg, gen=6, attn_impl=impl,
                         prefix_embeds=None if prefix is None else prefix.to(card))
    assert fa.kernel.launch_counts["flash_attention"] == (0 if cfg.attn_free
                                                          else cfg.num_layers)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert _err(got.prefill_logits.cpu(), want.prefill_logits) <= 1e-4
    assert _err(got.last_logits.cpu(), want.last_logits) <= 1e-4
    assert got.cache_len == want.cache_len


def test_a_shape_the_kernel_refuses_raises_through_the_serving_path(card):
    """head_dim 48 is not one of the kernel's instantiations: the prefill
    raises from the wrapper and nothing routes it to the plain attention."""
    import dataclasses
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("hymba-1.5b").reduced(), head_dim=48)
    params = transformer.init_params(torch.Generator(device=card).manual_seed(0), cfg)
    tokens = torch.zeros((1, 16), dtype=torch.long, device=card)
    with pytest.raises(ValueError, match="head_dim 48"):
        serve.generate(params, tokens, cfg, gen=1, attn_impl=fa.make_attn_impl())


# ---------------------------------------------- training attention ----
# The training kernels (kernels/flash_attention/csrc/flash_train.cu) through
# their autograd function, against autograd of the model's plain ``_sdpa`` on
# the same bf16 inputs and against the exact f32 result (the plain twins on
# the bf16 inputs widened). Element-wise tolerance: 2^-8 of |exact| (about one
# bf16 rounding of the output, which both sides make) plus 2^-7 of the
# tensor's largest |exact| (P and dS enter the tensor cores as one bf16
# rounding each, 2^-9 of each of the S terms of a row's sum); and the kernel's
# worst error at most 2.5x ``_sdpa``'s own on the same inputs (the one
# rounding ``_sdpa`` does not make, dS to bf16, measured 1.4-1.9x).

# (B, S, H, KV, dqk, dv, window): the per-layer heads of cells 2 and 4
# (granite, GQA 2), cell 6 (Moonlight, one kv head per q head), the zoo's
# 128 / 128, S off the tile, windows, and cell 6's own S = 8,192 at B = 1
TRAIN_ATTN = [(1, 1024, 16, 8, 64, 64, None), (1, 2048, 16, 8, 64, 64, None),
              (4, 1024, 16, 8, 64, 64, None), (1, 1024, 16, 16, 192, 128, None),
              (1, 2048, 16, 16, 192, 128, None), (1, 2048, 16, 8, 128, 128, None),
              (2, 1000, 4, 2, 64, 64, 100), (1, 1100, 4, 4, 192, 128, 333),
              (1, 8192, 16, 16, 192, 128, None)]


def _train_qkv(card, b, s, h, kv, dqk, dv, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
    return mk(b, s, h, dqk), mk(b, s, kv, dqk), mk(b, s, kv, dv), mk(b, s, h, dv)


def _sdpa_and_grads(q, k, v, do, win, scale):
    from repro_torch.models import attention, layers
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    s = q.shape[1]
    out = attention._sdpa(*leaves, layers.causal_mask(s, s, 0, win, device=q.device), scale)
    return (out.detach(),) + torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("b,s,h,kv,dqk,dv,win", TRAIN_ATTN)
def test_train_attention_kernels_match_autograd_of_sdpa(card, b, s, h, kv, dqk, dv, win):
    q, k, v, do = _train_qkv(card, b, s, h, kv, dqk, dv, seed=s + dqk)
    scale = dqk ** -0.5
    before = dict(fa.kernel.launch_counts)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.flash_train_attention(*leaves, window=win)
    got = (o.detach(),) + torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert {n: fa.kernel.launch_counts[n] - before[n] for n in before} == {
        "flash_attention": 0, "flash_train_fwd": 1, "flash_train_dq": 1, "flash_train_dkdv": 1}
    f = lambda x: x.float()
    eo, lse_exact = fa.flash_train_forward_ref(f(q), f(k), f(v), window=win, scale=scale)
    exact = (eo,) + fa.flash_train_backward_ref(f(q), f(k), f(v), eo, lse_exact, f(do), window=win,
                                                scale=scale)
    plain = _sdpa_and_grads(q, k, v, do, win, scale)
    for name, g, ex, pl, x in zip(("o", "dq", "dk", "dv"), got, exact, plain, (o, q, k, v)):
        want_shape = (b, s, h, dv) if name == "o" else x.shape
        assert g.shape == want_shape and g.dtype == torch.bfloat16, name
        bound = 2 ** -8 * ex.abs() + 2 ** -7 * float(ex.abs().max())
        assert bool(((g.float() - ex).abs() <= bound).all()), name
        assert _err(g, ex) <= 2.5 * _err(pl, ex) + 1e-6, (name, _err(g, ex), _err(pl, ex))
    _, lse = fa.kernel.flash_train_forward(q, k, v, window=win)
    assert _err(lse, lse_exact) <= 1e-5 * max(1.0, float(lse_exact.abs().max()))


def test_train_attention_backward_is_the_same_bits_from_run_to_run(card):
    q, k, v, do = _train_qkv(card, 1, 2048, 16, 8, 64, 64, seed=7)
    o, lse = fa.kernel.flash_train_forward(q, k, v)
    first = fa.kernel.flash_train_backward(q, k, v, o, lse, do)
    for _ in range(3):
        again = fa.kernel.flash_train_backward(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_train_attention_wrapper_raises_on_what_the_kernels_do_not_take(card):
    q, k, v, _ = _train_qkv(card, 1, 128, 4, 2, 64, 64)
    launches = dict(fa.kernel.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_train_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_train_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="16-byte"):            # rows 2 bytes off
        wide = torch.zeros((1, 128, 4, 65), dtype=torch.bfloat16, device=card)
        fa.flash_train_attention(wide[..., 1:], k, v)
    with pytest.raises(ValueError, match="widths"):
        fa.flash_train_attention(q, k, v[..., :32])
    with pytest.raises(ValueError, match="widths"):
        fa.flash_train_attention(*_train_qkv(card, 1, 64, 2, 2, 32, 32)[:3])
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_train_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_train_attention(q, k[:, :64], v[:, :64])
    with pytest.raises(ValueError, match="window"):
        fa.flash_train_attention(q, k, v, window=0)
    assert fa.kernel.launch_counts == launches
    assert not fa.kernel.train_takes(q.float(), k.float(), v.float())
    assert not fa.kernel.train_takes(q, k, v[..., :32])
    assert fa.kernel.train_takes(q, k, v)


@pytest.mark.parametrize("dtype,dv", [(torch.float32, 64), (torch.bfloat16, 32)])
def test_train_adapter_sends_f32_and_other_widths_to_sdpa_on_the_card(card, dtype, dv):
    from repro_torch.models import attention, layers
    q, k, v, do = (x.to(dtype) for x in _train_qkv(card, 1, 100, 4, 2, 64, dv, seed=3))
    launches = dict(fa.kernel.launch_counts)
    got = fa.make_train_attn_impl()(q, k, v, None, 0.125)
    want = attention._sdpa(q, k, v, layers.causal_mask(100, 100, 0, None, device=card), 0.125)
    assert torch.equal(got, want)
    assert fa.kernel.launch_counts == launches


def _mla_192(cfg):
    """A reduced Moonlight at the full model's attention widths (q/k 192 =
    128 + 64 rotary, v 128)."""
    import dataclasses
    return dataclasses.replace(cfg, head_dim=192, qk_rope_dim=64, v_head_dim=128)


@pytest.mark.parametrize("arch,compute_dtype,per_pass", [
    ("granite-moe-1b-a400m", torch.bfloat16, 1), ("moonlight-16b-a3b", torch.bfloat16, 1),
    ("granite-moe-1b-a400m", None, 0)])
def test_a_train_round_launches_the_training_attention(card, arch, compute_dtype, per_pass):
    """One round of V = 2 vehicles through ``build_dds_train_step``'s default
    attention: with bf16 compute, 2 L V forward launches (forward and remat's
    recompute) and L V of each backward kernel; in f32 none. The loss within
    the cells' 0.01 of a round through ``_sdpa``."""
    from repro_torch.launch import steps, train
    from repro_torch.models import attention, layers
    cfg = get_config(arch).reduced()
    if cfg.is_mla:
        cfg = _mla_192(cfg)

    def sdpa(q, k, v, mask, scale):
        s = q.shape[1]
        return attention._sdpa(q, k, v, layers.causal_mask(s, s, 0, None, device=q.device),
                                scale)

    def round_loss(attn_impl):
        gen = torch.Generator(device=card).manual_seed(0)
        params, opt, sm = steps.init_train_state(cfg, 2, gen)
        tokens = torch.randint(0, cfg.true_vocab_size, (2, 2, 256), generator=gen, device=card)
        ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=20, attn_impl=attn_impl,
                                        compute_dtype=compute_dtype)
        metrics = ts.fn(params, opt, sm, tokens, train.ring_contact(2, card),
                        torch.full((2,), 0.5, device=card))[3]
        return float(metrics["loss"])

    fa.kernel.reset_launch_counts()
    got = round_loss(None)
    torch.cuda.synchronize()
    n = cfg.num_layers * 2 * per_pass
    assert fa.kernel.launch_counts == {"flash_attention": 0, "flash_train_fwd": 2 * n,
                                       "flash_train_dq": n, "flash_train_dkdv": n}
    assert abs(got - round_loss(sdpa)) <= 1e-2


@pytest.mark.parametrize("arch,compute_dtype", [
    ("granite-moe-1b-a400m", torch.bfloat16), ("moonlight-16b-a3b", torch.bfloat16),
    ("granite-moe-1b-a400m", None)])
def test_a_train_round_launches_adamw_once_per_vehicle_step(card, arch, compute_dtype,
                                                           monkeypatch):
    """One round of V = 2 vehicles through ``build_dds_train_step``: each
    vehicle step's AdamW is ceil(leaves / 64) launches of the kernel (f32 and
    bf16 compute alike: the masters and their gradients are f32), and its
    parameters and moments equal, bit for bit, the train step's per-leaf loop
    (``steps.adamw_per_leaf_``) run on copies of the same inputs."""
    import math

    from repro_torch.kernels.adamw import kernel as adamw_kernel
    from repro_torch.launch import steps, train
    cfg = get_config(arch).reduced()
    real, same = steps.adamw_step_, []

    def checked(optimizer, rows, mu, nu, grads, count):
        want = [{k: x.clone() for k, x in tree.items()} for tree in (rows, mu, nu, grads)]
        steps.adamw_per_leaf_(optimizer, *want, count.clone())
        real(optimizer, rows, mu, nu, grads, count)
        for got, w in zip((rows, mu, nu), want):
            same.append(all(torch.equal(x.view(torch.int32), w[k].view(torch.int32))
                            for k, x in got.items()))

    monkeypatch.setattr(steps, "adamw_step_", checked)
    gen = torch.Generator(device=card).manual_seed(0)
    params, opt, sm = steps.init_train_state(cfg, 2, gen)
    tokens = torch.randint(0, cfg.true_vocab_size, (2, 2, 64), generator=gen, device=card)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=20, compute_dtype=compute_dtype)
    adamw_kernel.reset_launch_counts()
    ts.fn(params, opt, sm, tokens, train.ring_contact(2, card),
          torch.full((2,), 0.5, device=card))
    torch.cuda.synchronize()
    leaves = len(steps.flatten(params))
    assert adamw_kernel.launch_counts["adamw"] == 2 * math.ceil(leaves / adamw_kernel.max_leaves())
    assert same == [True] * 6


# --------------------------------------------------- the seed axis (run_seeds)

def _seed_case(seeds, k, d, seed, neighbour_only):
    """S seeds' mixing, dense [S, K, K] and as neighbour lists [S, K, D]; with
    ``neighbour_only`` the delayed-gossip part: zero diagonal, rows below one,
    row 1 of seed 0 all zeros."""
    r = np.random.default_rng(seed)
    w = r.dirichlet(np.ones(k), size=(seeds, k)).astype(np.float32)
    idx = r.integers(0, k, size=(seeds, k, d)).astype(np.int32)
    idx[..., 0] = np.arange(k)                      # a self slot on every row
    ws = r.random((seeds, k, d)).astype(np.float32)
    ws[..., -1] = 0.0
    if neighbour_only:
        w[:, np.arange(k), np.arange(k)] = 0.0
        w[0, 1] = 0.0
        ws[idx == np.arange(k)[None, :, None]] = 0.0
        ws[0, 1] = 0.0
    return (torch.as_tensor(w), torch.as_tensor(idx), torch.as_tensor(ws))


@pytest.mark.parametrize("neighbour_only", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seeds,k", [(3, 100), (2, 7), (4, 33)])
def test_seed_axis_matmul_kernel_matches_plain_version(card, seeds, k, dtype, neighbour_only):
    """W [S, K, K] over [S, K, P] leaves: one launch for every seed and leaf."""
    w, _, _ = _seed_case(seeds, k, 3, seeds + k, neighbour_only)
    w = w.to(card)
    r = np.random.default_rng(k)
    flats = [torch.as_tensor(r.normal(size=(seeds, k, p)).astype(np.float32)).to(dtype)
             .to(card) for p in GROUP_WIDTHS]
    before = kernel.launch_counts["gossip_mix_matmul"]
    got = gossip_mix_matmul_grouped(w, flats)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == before + 1
    for x, out in zip(flats, got):
        assert out.shape == x.shape and out.dtype == dtype
        assert _err(out, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]
        if neighbour_only:
            assert not out[0, 1].float().any()


@pytest.mark.parametrize("neighbour_only", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seeds,k,d", [(3, 100, 9), (2, 7, 4), (4, 33, 6)])
def test_seed_axis_gather_kernel_matches_plain_version(card, seeds, k, d, dtype,
                                                       neighbour_only):
    """[S, K, D] ids over [S, K, P] leaves, the seed folded into the row id:
    one launch for every seed and leaf."""
    from repro_torch.kernels.gossip_mix import ref
    _, idx, ws = _seed_case(seeds, k, d, seeds + k + d, neighbour_only)
    idx, ws = idx.to(card), ws.to(card)
    r = np.random.default_rng(d)
    flats = [torch.as_tensor(r.normal(size=(seeds, k, p)).astype(np.float32)).to(dtype)
             .to(card) for p in GROUP_WIDTHS]
    before = kernel.launch_counts["gossip_mix_gather"]
    got = kernel.gossip_mix_gather_grouped(idx, ws, flats)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_gather"] == before + 1
    for x, out in zip(flats, got):
        assert out.shape == x.shape and out.dtype == dtype
        assert _err(out, ref.gossip_mix_gather_ref(idx, ws, x)) <= ATOL[dtype]
        if neighbour_only:
            assert not out[0, 1].float().any()


@pytest.mark.parametrize("sparse", [False, True])
def test_mix_params_cuda_with_a_seed_axis_launches_once(card, sparse):
    """The delayed mix of a seed-stacked model: one launch for the sync mix,
    one for the neighbour-only mix; W = I gives the params bit for bit."""
    from repro_torch.core import vehicle_axis
    w, idx, ws = _seed_case(3, 6, 3, 0, False)
    mixing = contacts.SparseMixing(idx.to(card), ws.to(card)) if sparse else w.to(card)
    r = np.random.default_rng(1)
    tree = {"a": torch.as_tensor(r.normal(size=(3, 6, 2, 5)).astype(np.float32)).to(card),
            "b": torch.as_tensor(r.normal(size=(3, 6, 7)).astype(np.float32)).to(card)}
    stale = {n: v.flip(1).contiguous() for n, v in tree.items()}
    name = "gossip_mix_gather" if sparse else "gossip_mix_matmul"
    kernel.reset_launch_counts()
    got = vehicle_axis.delayed_gossip_mix(mix_params_cuda)(mixing, tree, stale)
    want = vehicle_axis.delayed_gossip_mix(aggregation.mix_params)(mixing, tree, stale)
    assert kernel.launch_counts[name] == 1
    for n in tree:
        assert got[n].shape == tree[n].shape and _err(got[n], want[n]) <= 1e-5
    if sparse:
        self_only = torch.zeros(idx.shape)
        self_only[..., 0] = 1.0                     # slot 0 is each row's own id
        ident = contacts.SparseMixing(idx.to(card), self_only.to(card))
    else:
        ident = torch.eye(6, device=card).expand(3, 6, 6).contiguous()
    same = vehicle_axis.delayed_gossip_mix(mix_params_cuda)(ident, tree, stale)
    assert all(torch.equal(same[n], tree[n]) for n in tree)


def test_run_seeds_on_the_card_launches_once_per_round_and_matches_single_runs(card):
    from dataclasses import replace
    from repro_torch.fed import engine
    ds = synthetic_mnist(n_train=1200, n_test=200)
    for fmt, overlap in (("sparse", "sync"), ("dense", "sync"), ("sparse", "delayed")):
        cfg = SimulationConfig(num_vehicles=8, epochs=3, eval_every=3, eval_samples=200,
                               local_steps=2, batch_size=16, p1_steps=40, comm_range=250.0,
                               contact_format=fmt, overlap=overlap, device="cuda")
        kernel.reset_launch_counts()
        batch = engine.run_seeds(cfg, [0, 1, 2], dataset=ds)
        name = "gossip_mix_gather" if fmt == "sparse" else "gossip_mix_matmul"
        assert kernel.launch_counts[name] == cfg.epochs
        for seed, res in enumerate(batch):
            single = run_simulation(replace(cfg, seed=seed), dataset=ds)
            np.testing.assert_allclose(np.stack(res.entropy), np.stack(single.entropy),
                                       atol=1e-5)
            np.testing.assert_allclose(res.kl_trace, single.kl_trace, atol=1e-5)
            np.testing.assert_allclose(res.comm_mb, single.comm_mb, atol=1e-5)
            assert np.isfinite(res.avg_accuracy).all()


def test_seed_axis_wrappers_raise_on_a_mismatched_seed_count(card):
    w, idx, ws = _seed_case(3, 5, 3, 0, False)
    x = torch.zeros(2, 5, 8, device=card)
    with pytest.raises(ValueError):
        gossip_mix_matmul_grouped(w.to(card), [x])
    with pytest.raises(ValueError):
        kernel.gossip_mix_gather_grouped(idx.to(card), ws.to(card), [x])
    with pytest.raises(ValueError):          # a 2-D leaf under a 3-D W
        gossip_mix_matmul_grouped(w.to(card), [x[0]])


# ----------------------------------------------- per-shard blocks (shard_map) ----

SHARD_WIDTHS = [250, 10, 5000, 20, 16000, 50, 500, 10]   # the MNIST CNN's 8 leaves


def _shard_mixing(k, seed, p=0.1):
    """A row-stochastic mixing on a random contact graph of K vehicles, dense
    and as a neighbour list with two padding slots (own id, weight 0)."""
    r = np.random.default_rng(seed)
    c = np.triu(r.random((k, k)) < p, 1)
    c = (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)
    dense = c * r.random((k, k)).astype(np.float32)
    dense /= dense.sum(1, keepdims=True)
    d = int(c.sum(1).max()) + 2
    idx = np.tile(np.arange(k, dtype=np.int32)[:, None], (1, d))
    w = np.zeros((k, d), np.float32)
    for row in range(k):
        nbrs = np.nonzero(c[row])[0]
        idx[row, :len(nbrs)] = nbrs
        w[row, :len(nbrs)] = dense[row, nbrs]
    return dense, idx, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_matmul_kernel_on_per_shard_blocks(card, n, dtype):
    """The dense mix of one shard: W[:, block] [100, 100/n] over [100/n, P_l]
    leaves in one launch; the n partials sum to the global mix."""
    from repro_torch.core import vehicle_axis
    k, k_local = 100, 100 // n
    dense, _, _ = _shard_mixing(k, 11)
    r = np.random.default_rng(12)
    leaves = [torch.as_tensor(r.normal(size=(k, p)).astype(np.float32)).to(dtype).to(card)
              for p in SHARD_WIDTHS]
    w = torch.as_tensor(dense).to(card)
    total = [torch.zeros(k, p, device=card) for p in SHARD_WIDTHS]
    for rank in range(n):
        start = rank * k_local
        block = vehicle_axis.local_mixing(w, start, k_local).contiguous()
        local = [x[start:start + k_local] for x in leaves]
        before = kernel.launch_counts["gossip_mix_matmul"]
        outs = gossip_mix_matmul_grouped(block, local)
        torch.cuda.synchronize()
        assert kernel.launch_counts["gossip_mix_matmul"] == before + 1
        for o, x in zip(outs, local):
            assert o.shape == (k, x.shape[1]) and o.dtype == dtype
            assert _err(o, gossip_mix_matmul_ref(block, x)) <= ATOL[dtype]
        total = [t + o.float() for t, o in zip(total, outs)]
    for t, x in zip(total, leaves):
        assert _err(t, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_gather_kernel_on_remapped_shard_ids(card, n, dtype):
    """The sparse mix of one shard: [100, D] ids remapped into [0, 100/n),
    clipped where the source is another shard's (weight zeroed), over
    [100/n, P_l] leaves in one launch; the n partials sum to the global mix."""
    from repro_torch.core import vehicle_axis
    k, k_local = 100, 100 // n
    _, idx, w = _shard_mixing(k, 13)
    mixing = contacts.SparseMixing(torch.as_tensor(idx).to(card), torch.as_tensor(w).to(card))
    r = np.random.default_rng(14)
    leaves = [torch.as_tensor(r.normal(size=(k, p)).astype(np.float32)).to(dtype).to(card)
              for p in SHARD_WIDTHS]
    total = [torch.zeros(k, p, device=card) for p in SHARD_WIDTHS]
    clipped = 0
    for rank in range(n):
        start = rank * k_local
        local_mix = vehicle_axis.local_mixing(mixing, start, k_local)
        ids = local_mix.idx.to(torch.int32).contiguous()
        assert int(ids.min()) >= 0 and int(ids.max()) < k_local
        clipped += int(((mixing.idx < start) | (mixing.idx >= start + k_local)).sum())
        local = [x[start:start + k_local] for x in leaves]
        before = kernel.launch_counts["gossip_mix_gather"]
        outs = kernel.gossip_mix_gather_grouped(ids, local_mix.w.contiguous(), local)
        torch.cuda.synchronize()
        assert kernel.launch_counts["gossip_mix_gather"] == before + 1
        for o, x in zip(outs, local):
            assert o.shape == (k, x.shape[1]) and o.dtype == dtype
            assert _err(o, gossip_mix_gather_ref(ids, local_mix.w, x)) <= ATOL[dtype]
        total = [t + o.float() for t, o in zip(total, outs)]
    assert clipped > 0
    want_ids = mixing.idx.contiguous()
    for t, x in zip(total, leaves):
        assert _err(t, gossip_mix_gather_ref(want_ids, mixing.w, x)) <= ATOL[dtype]


def test_resolve_auto_on_a_cuda_config_uses_the_h100_profile(card):
    """``execution="auto"`` on the card predicts with the H100 profile, and
    the run it resolves to goes through the mix kernel of its format."""
    from repro_torch.fed import engine
    from repro_torch.roofline import scenario_cost
    cfg = SimulationConfig(num_vehicles=8, epochs=2, eval_every=1, eval_samples=40,
                           local_steps=1, batch_size=4, p1_steps=5, contact_density=0.5,
                           execution="auto", device="cuda")
    resolved, plan = engine.resolve_execution(cfg)
    assert plan["host_profile"] == scenario_cost.H100.name == "h100"
    assert plan["device_count"] == 1 and resolved.execution == "manual"
    assert resolved.backend == "vmap" and resolved.mixing_backend == "cuda"
    kernel.reset_launch_counts()
    res = run_simulation(cfg, dataset=synthetic_mnist(n_train=400, n_test=40))
    torch.cuda.synchronize()
    assert res.execution_plan == plan
    used = ("gossip_mix_gather" if resolved.contact_format == "sparse"
            else "gossip_mix_matmul")
    assert kernel.launch_counts[used] == cfg.epochs


# ------------------------------------------- the train round (launch.steps)

def _train_state(arch, v, seed=0):
    """A reduced config's federation of ``v`` vehicles mid-training on the
    CPU: apart from one init, AdamW moments after three steps (second moments
    above the first's square), state vectors on the simplex; tokens and
    prefix."""
    from repro_torch.launch import steps
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    params, opt, _ = steps.init_train_state(cfg, v, gen)
    for leaf in steps.flatten(params).values():
        leaf[1:].add_(0.01 * torch.randn(leaf[1:].shape, generator=gen))
    for mu, nu in zip(steps.flatten(opt.mu).values(), steps.flatten(opt.nu).values()):
        mu.normal_(0.0, 1e-3, generator=gen)
        nu.uniform_(0.0, 1e-6, generator=gen).add_(2 * mu * mu)
    opt.count.fill_(3)
    sm = torch.rand((v, v), generator=gen)
    sm = sm / sm.sum(dim=1, keepdim=True)
    tokens = torch.randint(0, cfg.true_vocab_size, (v, 2, 16), generator=gen)
    prefix = (0.02 * torch.randn((v, 2, cfg.frontend_tokens, cfg.d_model), generator=gen)
              if cfg.embed_input else None)
    return cfg, (params, opt, sm), tokens, prefix


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES) + sorted(PORT_ONLY))
def test_reduced_train_round_on_the_card_matches_the_cpu(card, arch):
    """One ``build_dds_train_step`` round of a reduced config, 4 vehicles on a
    ring, on the card against the CPU: one grouped ``gossip_mix_matmul``
    launch, mixing the stack in place (every parameter leaf keeps its
    address), no flash launch (an f32 round attends through plain SDPA); loss,
    kl, state matrix, parameters and moments to 1e-4."""
    from repro_torch import convert
    from repro_torch.launch import steps, train
    cfg, state, tokens, prefix = _train_state(arch, 4)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=100)

    def run(device):
        with full_f32_matmul():
            return ts.fn(*convert.train_state_from_numpy(*state, device=device),
                         tokens.to(device), train.ring_contact(4, device),
                         torch.full((4,), 0.25, device=device),
                         None if prefix is None else prefix.to(device))

    want = run("cpu")
    kernel.reset_launch_counts()
    fa.kernel.reset_launch_counts()
    start = convert.train_state_from_numpy(*state, device=card)
    ptrs = {k: x.data_ptr() for k, x in steps.flatten(start[0]).items()}
    with full_f32_matmul():
        got = ts.fn(*start, tokens.to(card), train.ring_contact(4, card),
                    torch.full((4,), 0.25, device=card),
                    None if prefix is None else prefix.to(card))
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == 1
    assert {k: x.data_ptr() for k, x in steps.flatten(got[0]).items()} == ptrs  # in place
    assert all(n == 0 for n in fa.kernel.launch_counts.values())
    for name in ("loss", "kl"):
        assert abs(float(got[3][name]) - float(want[3][name])) <= 1e-4
    assert _err(got[2].cpu(), want[2]) <= 1e-4
    assert torch.equal(got[1].count.cpu(), want[1].count)
    for tree in (0, "mu", "nu"):
        g = steps.flatten(got[0] if tree == 0 else getattr(got[1], tree))
        w = steps.flatten(want[0] if tree == 0 else getattr(want[1], tree))
        assert max(_err(g[k].cpu(), w[k]) for k in w) <= 1e-4


def test_a_train_round_past_the_column_mapping_copies_the_tile_mix_back(card):
    """V = 17 vehicles, one past the column mapping's limit: the round's
    default mix cannot write into the stack, so it takes the functional
    ``mix_params_cuda`` (one tile-mapping launch) and copies it back — every
    parameter leaf keeps its address; loss, kl, state matrix and parameters
    within 1e-4 of the same round on the CPU (which mixes in place)."""
    from repro_torch import convert
    from repro_torch.launch import steps, train
    v = 17
    assert kernel.matmul_path(v, v) == kernel.MATMUL_TILES
    cfg, state, tokens, _ = _train_state("qwen3-1.7b", v, seed=17)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=100)

    def run(device):
        start = convert.train_state_from_numpy(*state, device=device)
        ptrs = {k: x.data_ptr() for k, x in steps.flatten(start[0]).items()}
        with full_f32_matmul():
            out = ts.fn(*start, tokens.to(device), train.ring_contact(v, device),
                        torch.full((v,), 1.0 / v, device=device))
        assert {k: x.data_ptr() for k, x in steps.flatten(out[0]).items()} == ptrs
        return out

    want = run("cpu")
    kernel.reset_launch_counts()
    got = run(card)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == 1
    for name in ("loss", "kl"):
        assert abs(float(got[3][name]) - float(want[3][name])) <= 1e-4
    assert _err(got[2].cpu(), want[2]) <= 1e-4
    w = steps.flatten(want[0])
    assert max(_err(x.cpu(), w[k]) for k, x in steps.flatten(got[0]).items()) <= 1e-4


@pytest.mark.parametrize("k", [2, 3, 4])
def test_mix_params_cuda_on_a_transformer_tree_of_few_vehicles(card, k):
    """The train round's mix: a flattened stacked transformer (every family's
    leaves of the reduced qwen3 and granite-moe) at K = 2-4 vehicles, far
    below the kernel's 128-row tile: one launch, the plain product to 1e-5."""
    from repro_torch.launch import steps
    leaves = {}
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        cfg, (params, _, _), _, _ = _train_state(arch, k, seed=k)
        leaves.update({f"{arch}/{n}": x.to(card) for n, x in steps.flatten(params).items()})
    w = torch.as_tensor(np.random.default_rng(k).dirichlet(np.ones(k), size=k)
                        .astype(np.float32)).to(card)
    kernel.reset_launch_counts()
    got = mix_params_cuda(w, leaves)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == 1
    with full_f32_matmul():
        want = aggregation.mix_params(w, leaves)
    for name, x in leaves.items():
        assert got[name].shape == x.shape
        assert _err(got[name], want[name]) <= 1e-5, name


# ------------------------------- the column mapping (few rows), in place

SMALL_WIDTHS = [1, 63, 65, 4097]


def _small_case(k_out, k_in, widths, dtype, seed, card, seeds=None):
    r = np.random.default_rng(seed)
    lead = () if seeds is None else (seeds,)
    w = torch.as_tensor(r.dirichlet(np.ones(k_in), size=lead + (k_out,))
                        .astype(np.float32)).to(card)
    flats = [torch.as_tensor(r.normal(size=lead + (k_in, p)).astype(np.float32))
             .to(dtype).to(card) for p in widths]
    return w, flats


def _in_place_equals_out_of_place(w, flats):
    """One launch out of place, one in place on copies: returns (the outputs,
    the copies mixed in place); the copies keep their addresses."""
    before = kernel.launch_counts["gossip_mix_matmul"]
    outs = gossip_mix_matmul_grouped(w, flats)
    copies = [x.clone() for x in flats]
    ptrs = [x.data_ptr() for x in copies]
    got = gossip_mix_matmul_grouped(w, copies, out=copies)
    torch.cuda.synchronize()
    assert kernel.launch_counts["gossip_mix_matmul"] == before + 2
    assert all(g is c and c.data_ptr() == ptr for g, c, ptr in zip(got, copies, ptrs))
    return outs, copies


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", list(range(1, 18)))
def test_small_k_matmul_in_and_out_of_place(card, k, dtype):
    """K = 1-17 vehicles, on both sides of the column mapping's limit (the
    launcher's choice, ``kernel.matmul_path``), over widths of one column,
    not a multiple of 4 and past one tile: one launch against the plain
    version (f32 1e-5, bf16 5e-2); where the mapping mixes in place, in
    place equals out of place bit for bit; where it does not, in place
    raises."""
    w, flats = _small_case(k, k, SMALL_WIDTHS, dtype, k, card)
    path = kernel.matmul_path(k, k)
    assert path in (kernel.MATMUL_COLUMNS, kernel.MATMUL_TILES)
    if path == kernel.MATMUL_TILES:
        outs = gossip_mix_matmul_grouped(w, flats)
        with pytest.raises(ValueError):
            gossip_mix_matmul_grouped(w, flats, out=flats)
    else:
        outs, copies = _in_place_equals_out_of_place(w, flats)
        assert all(torch.equal(o, c) for o, c in zip(outs, copies))
    for x, out in zip(flats, outs):
        assert out.shape == x.shape and out.dtype == dtype
        assert _err(out, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]


def test_the_train_round_and_the_federation_take_their_mappings(card):
    """Few vehicles (the train round's K = 2, a per-shard [8, 2] block, a
    [4, 100] W) take the column mapping; the federation's K = 100 and its
    per-shard blocks keep the tile mapping."""
    for k_out, k_in in ((2, 2), (4, 4), (8, 2), (4, 100)):
        assert kernel.matmul_path(k_out, k_in) == kernel.MATMUL_COLUMNS
    for k_out, k_in in ((100, 100), (100, 50), (100, 25)):
        assert kernel.matmul_path(k_out, k_in) == kernel.MATMUL_TILES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_k_matmul_with_a_seed_axis_in_place(card, dtype):
    """S = 3 seeds at K = 4 in one launch: against the plain version per seed,
    in place equal to out of place bit for bit."""
    w, flats = _small_case(4, 4, SMALL_WIDTHS, dtype, 3, card, seeds=3)
    outs, copies = _in_place_equals_out_of_place(w, flats)
    for x, out, c in zip(flats, outs, copies):
        assert out.shape == x.shape and torch.equal(out, c)
        assert _err(out, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]


@pytest.mark.parametrize("k_out,k_in", [(4, 100), (8, 2), (3, 300)])
def test_small_k_matmul_on_rectangular_w(card, k_out, k_in):
    """A rectangular W with few rows: any K_in (streamed in chunks past 256
    rows), out of place only — an output on the input's rows is refused."""
    w, flats = _small_case(k_out, k_in, SMALL_WIDTHS, torch.float32, k_out + k_in, card)
    outs = gossip_mix_matmul_grouped(w, flats)
    torch.cuda.synchronize()
    for x, out in zip(flats, outs):
        assert out.shape == (k_out, x.shape[1])
        assert _err(out, gossip_mix_matmul_ref(w, x)) <= 1e-5
    if k_out <= k_in:
        with pytest.raises(ValueError):
            gossip_mix_matmul_grouped(w, flats, out=[x[:k_out] for x in flats])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_k_matmul_on_an_unaligned_leaf(card, dtype):
    """A leaf view 4 (f32) / 2 (bf16) bytes off a 16-byte boundary beside
    aligned leaves: the element-wise path, in place and out of place."""
    w, flats = _small_case(3, 3, [64, 100, 4096], dtype, 11, card)
    shifted = torch.zeros(3 * 64 + 1, dtype=dtype, device=card)[1:].view(3, 64)
    flats[0] = shifted.copy_(flats[0])
    outs, copies = _in_place_equals_out_of_place(w, flats)
    for x, out, c in zip(flats, outs, copies):
        assert torch.equal(out, c) and _err(out, gossip_mix_matmul_ref(w, x)) <= ATOL[dtype]
    copy = torch.zeros(3 * 64 + 1, dtype=dtype, device=card)[1:].view(3, 64).copy_(flats[0])
    gossip_mix_matmul_grouped(w, [copy], out=[copy])
    assert torch.equal(copy, outs[0])


def test_the_tile_mapping_still_holds_k100(card):
    """K = 100 (the federation) through the tile mapping, within 1e-5 of the
    plain version in f32, and it does not mix in place."""
    w, flats = _small_case(100, 100, GROUP_WIDTHS, torch.float32, 100, card)
    outs = gossip_mix_matmul_grouped(w, flats)
    torch.cuda.synchronize()
    assert all(_err(o, gossip_mix_matmul_ref(w, x)) <= 1e-5 for o, x in zip(outs, flats))
    with pytest.raises(ValueError):
        gossip_mix_matmul_grouped(w, flats, out=flats)


def test_aliased_outputs_are_refused_by_the_wrapper_and_the_launcher(card):
    """In place where the mapping does not take it, a partial overlap, an
    output on another leaf's input and two overlapping outputs: the wrapper
    raises ValueError, and the C launcher, called with the same pointers,
    returns cudaErrorInvalidValue without launching."""
    import ctypes
    w, flats = _small_case(4, 4, [256, 256], torch.float32, 5, card)
    buf = torch.zeros(4 * 256 + 8, device=card)
    x, shifted = buf[:1024].view(4, 256), buf[4:1028].view(4, 256)
    w17, flats17 = _small_case(17, 17, [256], torch.float32, 6, card)
    cases = ((w17, flats17, flats17),                                # tile mapping
             (w, [x], [shifted]),                                   # partial overlap
             (w, flats, [flats[1], torch.empty_like(flats[0])]),    # another leaf's input
             (w, flats, [x, shifted]))                              # outputs overlap
    kernel.build()
    launch = kernel._LIBS["gossip_mix_matmul"].gossip_mix_matmul_grouped_launch
    for mixing, ins, outs in cases:
        with pytest.raises(ValueError):
            gossip_mix_matmul_grouped(mixing, ins, out=outs)
        n = len(ins)
        code = launch(mixing.data_ptr(), (ctypes.c_void_p * n)(*(t.data_ptr() for t in ins)),
                      (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs)),
                      (ctypes.c_longlong * n)(*(t.shape[1] for t in ins)), n, 1,
                      mixing.shape[0], mixing.shape[1], 0,
                      torch.cuda.current_stream().cuda_stream)
        assert code == 1                                           # cudaErrorInvalidValue


@pytest.mark.parametrize("k", [2, 4])
def test_mix_params_cuda__on_a_transformer_tree_of_few_vehicles(card, k):
    """The train round's default mix: a flattened stacked transformer (the
    reduced qwen3 and granite-moe, one bf16 leaf beside) mixed in place, one
    launch per dtype, every leaf at its address, bit for bit the functional
    ``mix_params_cuda`` and within 1e-5 of ``aggregation.mix_params``; a
    sparse mixing and a W the column mapping does not take raise."""
    from repro_torch.launch import steps
    leaves = {}
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        cfg, (params, _, _), _, _ = _train_state(arch, k, seed=k)
        leaves.update({f"{arch}/{n}": x.to(card) for n, x in steps.flatten(params).items()})
    leaves["half"] = next(iter(leaves.values())).to(torch.bfloat16)
    w = torch.as_tensor(np.random.default_rng(k).dirichlet(np.ones(k), size=k)
                        .astype(np.float32)).to(card)
    want = mix_params_cuda(w, leaves)
    with full_f32_matmul():
        plain = aggregation.mix_params(w, leaves)
    ptrs = {n: x.data_ptr() for n, x in leaves.items()}
    kernel.reset_launch_counts()
    got = mix_params_cuda_(w, leaves)
    torch.cuda.synchronize()
    assert got is leaves and kernel.launch_counts["gossip_mix_matmul"] == 2   # f32, bf16
    for name, x in leaves.items():
        assert x.data_ptr() == ptrs[name] and torch.equal(x, want[name]), name
        assert _err(x, plain[name]) <= ATOL[x.dtype], name
    idx = torch.zeros(k, 2, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        mix_params_cuda_(contacts.SparseMixing(idx, torch.ones(k, 2, device=card)), leaves)
    wide = torch.eye(100, device=card)
    with pytest.raises(ValueError):
        mix_params_cuda_(wide, {"a": torch.zeros(100, 8, device=card)})


# ------------------------------------------------------ grouped products ----

# (M, K, N, group sizes): empty groups first, inside and last; rows past the
# last group; tiles that straddle several boundaries; ragged K and N. Then
# the persistent kernel's edges: a group ending inside a 128-row tile with
# the next starting there; one group of several row tiles; N = 136 (a
# multiple of 8, not of the 128-column tile); K = 72 (16-byte rows, not a
# multiple of either stage depth, 32 or 64); the decode case, 16 rows over 32
# experts, most of them empty
DECODE_SIZES = [2, 0, 0, 1, 0, 3, 0, 0, 0, 1, 0, 0, 2, 0, 0, 0,
                1, 0, 0, 0, 0, 4, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0]
GROUPED = [(12, 24, 20, [3, 0, 5, 0, 2]), (130, 70, 33, [0, 64, 1, 0, 65]),
           (300, 128, 64, [50] * 6), (1000, 96, 130, [0] * 7 + [1000]),
           (257, 40, 256, [100, 0, 0, 157]), (64, 16, 16, [1] * 64),
           (300, 64, 64, [100, 200]), (700, 48, 128, [700]), (200, 64, 136, [80, 0, 120]),
           (150, 72, 40, [60, 90]), (16, 1024, 512, DECODE_SIZES)]


def _grouped_case(m, k, n, sizes, dtype, seed, card):
    r = np.random.default_rng(seed)
    x = torch.as_tensor(r.normal(size=(m, k)).astype(np.float32) / np.sqrt(k))
    w = torch.as_tensor(r.normal(size=(len(sizes), k, n)).astype(np.float32))
    dy = torch.as_tensor(r.normal(size=(m, n)).astype(np.float32))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    return [t.to(card) if t.dtype == torch.int32 else t.to(dtype).to(card)
            for t in (x, w, dy, offsets)]


def _within_scale(got, want, dtype):
    if dtype == torch.float32:      # 1e-5 of the plain version's scale
        return _err(got, want) <= 1e-5 * max(1.0, float(want.float().abs().max()))
    return torch.allclose(got.float(), want.float(), atol=5e-2, rtol=3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("m,k,n,sizes", GROUPED)
def test_grouped_mm_kernel_matches_plain_version(card, m, k, n, sizes, trans_w, dtype):
    from repro_torch.kernels.grouped_mm import grouped_mm_ref, kernel as gk
    x, w, _, offsets = _grouped_case(m, k, n, sizes, dtype, m + n, card)
    if trans_w:
        w = w.transpose(1, 2).contiguous()
    before = gk.launch_counts["grouped_mm"]
    got = gk.grouped_mm(x, w, offsets, trans_w)
    torch.cuda.synchronize()
    assert gk.launch_counts["grouped_mm"] == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    with full_f32_matmul():
        want = grouped_mm_ref(x, w, offsets, trans_w)
    assert _within_scale(got, want, dtype)
    if sum(sizes) < m:
        assert not got[sum(sizes):].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,sizes", GROUPED)
def test_grouped_mm_wgrad_kernel_matches_plain_version(card, m, k, n, sizes, dtype):
    from repro_torch.kernels.grouped_mm import grouped_mm_wgrad_ref, kernel as gk
    x, _, dy, offsets = _grouped_case(m, k, n, sizes, dtype, m * n, card)
    before = gk.launch_counts["grouped_mm_wgrad"]
    got = gk.grouped_mm_wgrad(x, dy, offsets)
    torch.cuda.synchronize()
    assert gk.launch_counts["grouped_mm_wgrad"] == before + 1
    assert got.shape == (len(sizes), k, n) and got.dtype == dtype
    with full_f32_matmul():
        want = grouped_mm_wgrad_ref(x, dy, offsets)
    assert _within_scale(got, want, dtype)
    for e, size in enumerate(sizes):
        if size == 0:
            assert not got[e].any()


def test_grouped_mm_op_gradients_on_the_card_match_the_cpu(card):
    """The custom op's backward on the card (the product with the transpose
    flag flipped, and the weight-gradient kernel) against autograd of the
    plain version on the CPU."""
    from repro_torch.kernels.grouped_mm import kernel as gk, ops as gops
    x, w, dy, offsets = _grouped_case(*GROUPED[1], torch.float32, 3, "cpu")
    grads = {}
    for device in ("cpu", card):
        xt = x.to(device).detach().requires_grad_()
        wt = w.to(device).detach().requires_grad_()
        gk.reset_launch_counts()
        with full_f32_matmul():
            (gops.grouped_mm(xt, wt, offsets.to(device)) * dy.to(device)).sum().backward()
        grads[str(device)] = (xt.grad.cpu(), wt.grad.cpu())
    assert gk.launch_counts == {"grouped_mm": 2, "grouped_mm_wgrad": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _within_scale(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans_w", [False, True])
def test_grouped_mm_zeroes_the_rows_in_no_group(card, trans_w, dtype):
    """Offsets that start past row 0 and end before M: the launch zeroes
    [0, offsets[0]) and [offsets[E], M) as well (into an output that held
    other values)."""
    from repro_torch.kernels.grouped_mm import grouped_mm_ref, kernel as gk
    x, w, _, _ = _grouped_case(300, 64, 96, [1, 1, 1], dtype, 5, card)
    if trans_w:
        w = w.transpose(1, 2).contiguous()
    offsets = torch.tensor([20, 150, 150, 270], dtype=torch.int32, device=card)
    torch.empty((300, 96), dtype=dtype, device=card).fill_(7.0)   # reused by the next alloc
    got = gk.grouped_mm(x, w, offsets, trans_w)
    torch.cuda.synchronize()
    with full_f32_matmul():
        want = grouped_mm_ref(x, w, offsets, trans_w)
    assert _within_scale(got, want, dtype)
    assert not got[:20].any() and not got[270:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_replays_in_a_cuda_graph_with_new_offsets(card, dtype):
    """The launch reads no group size on the host: captured once in a CUDA
    graph, it follows new sizes written into the same offsets tensor (the
    forward, its transpose and the weight gradient)."""
    from repro_torch.kernels.grouped_mm import grouped_mm_ref, grouped_mm_wgrad_ref, kernel as gk
    x, w, dy, offsets = _grouped_case(300, 64, 96, [100, 0, 150, 50], dtype, 4, card)
    calls = (lambda: gk.grouped_mm(x, w, offsets), lambda: gk.grouped_mm(dy, w, offsets, True),
             lambda: gk.grouped_mm_wgrad(x, dy, offsets))
    for fn in calls:                     # build and size the launches outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in calls]
    for sizes in ([100, 0, 150, 50], [7, 130, 0, 120], [0, 0, 0, 290]):
        offsets.copy_(torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)))
        graph.replay()
        torch.cuda.synchronize()
        with full_f32_matmul():
            wants = (grouped_mm_ref(x, w, offsets), grouped_mm_ref(dy, w, offsets, True),
                     grouped_mm_wgrad_ref(x, dy, offsets))
        for got, want in zip(outs, wants):
            assert _within_scale(got, want, dtype), sizes
        assert not outs[0][sum(sizes):].any()


def test_grouped_mm_wrapper_refusals(card):
    from repro_torch.kernels.grouped_mm import kernel as gk
    x, w, _, offsets = _grouped_case(*GROUPED[0], torch.float32, 0, card)
    with pytest.raises(TypeError, match="one dtype"):
        gk.grouped_mm(x, w.bfloat16(), offsets)
    with pytest.raises(ValueError, match="int32"):
        gk.grouped_mm(x, w, offsets.long())
    with pytest.raises(ValueError, match="contiguous"):
        gk.grouped_mm(x.T.contiguous().T, w, offsets)
    with pytest.raises(ValueError, match="do not agree"):
        gk.grouped_mm(x, w, offsets[:-1])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_ragged_moe_on_the_card_matches_the_cpu_and_the_dense_path(card, arch):
    """``moe_ragged`` of a reduced config on the card (three grouped launches
    forward, six backward) against the CPU, and against ``moe_dense`` on the
    card: output, the input's and every parameter's gradient (1e-4 of the scale:
    ``index_add_`` sums with atomics on the card)."""
    from repro_torch.kernels.grouped_mm import kernel as gk
    from repro_torch.models import moe
    cfg = get_config(arch).reduced()
    params = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    r = np.random.default_rng(2)
    x = torch.as_tensor(0.5 * r.normal(size=(96, cfg.d_model)).astype(np.float32))
    ct = torch.as_tensor(r.normal(size=(96, cfg.d_model)).astype(np.float32))
    runs = {}
    for name, device, fn in (("cpu", "cpu", moe.moe_ragged), ("card", card, moe.moe_ragged),
                             ("dense", card, moe.moe_dense)):
        p = {n: v.to(device).detach().requires_grad_() for n, v in params.items()}
        xt = x.to(device).detach().requires_grad_()
        gk.reset_launch_counts()
        with full_f32_matmul():
            out, aux = fn(p, xt, cfg)
            ((out * ct.to(device)).sum() + aux).backward()
        torch.cuda.synchronize()
        if name == "card":
            assert gk.launch_counts == {"grouped_mm": 6, "grouped_mm_wgrad": 3}
        runs[name] = [out.detach().cpu(), xt.grad.cpu()] + [p[n].grad.cpu() for n in sorted(p)]
    for other in ("card", "dense"):
        for got, want in zip(runs[other], runs["cpu"]):
            assert _err(got, want) <= 1e-4 * max(1.0, float(want.abs().max())), other
