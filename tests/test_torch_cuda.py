"""The port's CUDA kernels on a GPU (marker ``cuda``; skipped where there is
no CUDA device). Imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, f32 atol
1e-5 / bf16 atol 5e-2 (the reference's kernel-test tolerances).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aggregation, contacts
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed.simulator import SimulationConfig, run_simulation
from repro_torch.kernels.gossip_mix import (gossip_mix_gather_ref,
                                            gossip_mix_matmul_ref, kernel,
                                            mix_params_cuda)

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


def test_mix_params_cuda_launches_one_kernel_per_leaf(card):
    r = np.random.default_rng(0)
    k = 6
    tree = {"a": torch.as_tensor(r.normal(size=(k, 3, 5)).astype(np.float32)).to(card),
            "b": torch.as_tensor(r.normal(size=(k, 11)).astype(np.float32)).to(card)}
    w = torch.as_tensor(r.dirichlet(np.ones(k), size=k).astype(np.float32)).to(card)
    idx = torch.as_tensor(r.integers(0, k, size=(k, 3)).astype(np.int32)).to(card)
    ws = torch.as_tensor(r.random((k, 3)).astype(np.float32)).to(card)
    for mixing, name in ((w, "gossip_mix_matmul"),
                         (contacts.SparseMixing(idx, ws), "gossip_mix_gather")):
        kernel.reset_launch_counts()
        got = mix_params_cuda(mixing, tree)
        want = aggregation.mix_params(mixing, tree)
        assert kernel.launch_counts[name] == len(tree)
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
    with pytest.raises(ValueError):          # W does not fit a block's shared memory
        kernel.gossip_mix_matmul(torch.eye(300, device=card), torch.ones(300, 8, device=card))
    with pytest.raises(TypeError):
        kernel.gossip_mix_gather(torch.zeros(4, 2, dtype=torch.int64, device=card),
                                 torch.ones(4, 2, device=card), x)
    with pytest.raises(ValueError):
        kernel.gossip_mix_gather(torch.zeros(4, 2, dtype=torch.int32),
                                 torch.ones(4, 2, device=card), x)


@pytest.mark.parametrize("contact_format", ["sparse", "dense"])
def test_small_federation_on_the_card_matches_the_cpu(card, contact_format):
    ds = synthetic_mnist(n_train=1200, n_test=200)
    base = dict(num_vehicles=8, epochs=4, eval_every=2, eval_samples=200,
                local_steps=2, batch_size=16, p1_steps=40, comm_range=250.0,
                num_rsus=1, p_drop=0.1, contact_format=contact_format)
    kernel.reset_launch_counts()
    on_card = run_simulation(SimulationConfig(**base, device="cuda"), dataset=ds)
    used = "gossip_mix_gather" if contact_format == "sparse" else "gossip_mix_matmul"
    assert kernel.launch_counts[used] == 4 * 8
    on_cpu = run_simulation(SimulationConfig(**base, device="cpu"), dataset=ds)
    np.testing.assert_allclose(on_card.kl_trace, on_cpu.kl_trace, atol=1e-5)
    np.testing.assert_allclose(on_card.comm_mb, on_cpu.comm_mb, atol=1e-5)
    np.testing.assert_allclose(np.stack(on_card.entropy), np.stack(on_cpu.entropy), atol=1e-5)
