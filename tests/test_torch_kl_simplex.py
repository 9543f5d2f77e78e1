"""Port vs reference, the kl_simplex entry point: the state diagnostics
``kl_rows`` / ``entropy_rows``, the exponentiated-gradient step and the fused
P1 solver. The reference's Pallas kernels run in interpret mode on the CPU;
the port's ``ops`` take their plain versions on CPU tensors. Same numpy
inputs to both, atol 1e-5 (the reference's own kernel-test tolerance: the
two libraries' log / exp differ in the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from repro.kernels import kl_simplex as ref_kl
from repro_torch.core import contacts, kl_solver
from repro_torch.kernels import kl_simplex

T = torch.as_tensor

# V in 1..40, K in 2..50 (the reference's property sweep), corners included;
# a K off the CUDA kernels' 16-byte loads at a width of a few hundred, and the
# scale sweep's K = 1,024 with few rows
ROW_SHAPES = [(1, 2), (40, 50), (7, 13), (23, 2), (1, 50), (16, 31), (40, 3), (9, 48),
              (6, 301), (3, 1024)]


def _rows(v, k, seed):
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=v).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0                    # lanes under the 1e-12 cut
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    return s, g


@pytest.mark.parametrize("v,k", ROW_SHAPES)
def test_row_diagnostics_match_reference_kernels(v, k):
    s, g = _rows(v, k, v * 100 + k)
    want_kl = np.asarray(ref_kl.kl_rows_kernel(jnp.asarray(s), jnp.asarray(g), interpret=True))
    want_h = np.asarray(ref_kl.entropy_rows_kernel(jnp.asarray(s), interpret=True))
    for got_kl, got_h in ((kl_simplex.kl_rows(T(s), T(g)), kl_simplex.entropy_rows(T(s))),
                          (kl_simplex.kl_rows_ref(T(s), T(g)), kl_simplex.entropy_rows_ref(T(s)))):
        assert got_kl.dtype == got_h.dtype == torch.float32 and got_kl.shape == (v,)
        np.testing.assert_allclose(got_kl.numpy(), want_kl, atol=1e-5)
        np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-5)


def test_row_diagnostics_read_bf16_as_f32():
    s, g = _rows(12, 40, 5)
    sb = jnp.asarray(s, jnp.bfloat16)
    st = T(s).to(torch.bfloat16)
    np.testing.assert_allclose(kl_simplex.kl_rows(st, T(g)).numpy(),
                               np.asarray(ref_kl.kl_rows_kernel(sb, jnp.asarray(g), interpret=True)),
                               atol=1e-5)
    np.testing.assert_allclose(kl_simplex.entropy_rows(st).numpy(),
                               np.asarray(ref_kl.entropy_rows_kernel(sb, interpret=True)),
                               atol=1e-5)


def _eg_inputs(v, k, seed):
    r = np.random.default_rng(seed)
    m = (r.random((v, k)) < 0.5).astype(np.float32)
    m[:, 0] = 1.0                                   # every row has an active lane
    a = r.dirichlet(np.ones(k), size=v).astype(np.float32) * m
    a = (a / a.sum(1, keepdims=True)).astype(np.float32)
    g = r.normal(size=(v, k)).astype(np.float32)
    return a, g, m


@pytest.mark.parametrize("v,k,step", [(4, 8, 2.0), (33, 100, 2.0), (128, 16, 2.0),
                                      (5, 37, 0.5)])
def test_eg_step_matches_reference_kernel(v, k, step):
    a, g, m = _eg_inputs(v, k, v * k)
    want = np.asarray(ref_kl.eg_step(jnp.asarray(a), jnp.asarray(g), jnp.asarray(m),
                                     step_size=step, interpret=True))
    got = kl_simplex.eg_step_ref(T(a), T(g), T(m), step_size=step)
    assert got.dtype == torch.float32 and got.shape == (v, k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.numpy()[m == 0] == 0).all()
    np.testing.assert_allclose(got.numpy().sum(1), 1.0, atol=1e-5)


def test_eg_step_on_an_empty_mask_row():
    """The Pallas kernel gives 0 on a row whose mask is all zero (the CUDA
    kernel follows it; pinned on the card); the reference's plain version
    gives NaN there, and so does the port's."""
    a, g, m = _eg_inputs(3, 6, 1)
    m[1] = 0.0
    kernel_out = np.asarray(ref_kl.eg_step(jnp.asarray(a), jnp.asarray(g), jnp.asarray(m),
                                           interpret=True))
    assert (kernel_out[1] == 0).all()
    want = np.asarray(ref_kl.eg_step_ref(jnp.asarray(a), jnp.asarray(g), jnp.asarray(m)))
    got = kl_simplex.eg_step_ref(T(a), T(g), T(m)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    np.testing.assert_allclose(got[[0, 2]], kernel_out[[0, 2]], atol=1e-5)


def _p1_inputs(k, seed):
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=k).astype(np.float32)
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    c = np.minimum((r.random((k, k)) < 0.3) + (r.random((k, k)) < 0.3).T + np.eye(k),
                   1).astype(np.float32)
    return s, g, c


@pytest.mark.parametrize("num_steps,step", [(400, 2.0), (60, 0.5)])
def test_fused_p1_solver_matches_reference_and_core_objective(num_steps, step):
    s, g, c = _p1_inputs(20, 9)
    want = np.asarray(ref_kl.solve_p1_all_fused(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(c), num_steps=num_steps,
        step_size=step, interpret=True))
    got = kl_simplex.solve_p1_all_fused(T(s), T(g), T(c), num_steps=num_steps,
                                        step_size=step)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.numpy()[c == 0] == 0).all()
    eager = kl_solver.solve_p1_all(T(s), T(g), T(c), num_steps=num_steps, step_size=step)
    np.testing.assert_allclose(kl_solver.kl_objective(got, T(s), T(g)).numpy(),
                               kl_solver.kl_objective(eager, T(s), T(g)).numpy(), atol=1e-5)


def test_fused_p1_solver_is_dense_only():
    s, g, c = _p1_inputs(6, 2)
    sparse = contacts.SparseContacts(torch.zeros(6, 3, dtype=torch.int32), torch.ones(6, 3))
    with pytest.raises(TypeError):
        kl_simplex.solve_p1_all_fused(T(s), T(g), sparse)


def test_cuda_wrappers_refuse_cpu_tensors():
    s, g = _rows(3, 5, 0)
    a, gr, m = _eg_inputs(3, 5, 0)
    for call in (lambda: kl_simplex.kl_rows_kernel(T(s), T(g)),
                 lambda: kl_simplex.entropy_rows_kernel(T(s)),
                 lambda: kl_simplex.eg_step(T(a), T(gr), T(m)),
                 lambda: kl_simplex.eg_solve(T(s), T(g), T(m[:, :3]).contiguous(),
                                             num_steps=2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert sorted(kl_simplex.kernel.launch_counts) == ["eg_solve", "eg_step", "entropy_rows",
                                                       "kl_rows"]


def _p1_case(v, k, seed, empty_row):
    """States [V, K], a target, a 0/1 contact matrix [V, V] with a self
    contact on every row; with ``empty_row``, row 1 has no contact at all."""
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=v).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0                    # a data source nobody holds
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    c = np.minimum((r.random((v, v)) < 0.3) + np.eye(v), 1).astype(np.float32)
    if empty_row:
        c[1] = 0.0
    return s, g, c


@pytest.mark.parametrize("v,k,num_steps,step,empty_row",
                         [(20, 20, 200, 2.0, True), (20, 20, 200, 2.0, False),
                          (8, 8, 1, 2.0, True), (12, 30, 60, 0.5, True)])
def test_eg_solve_ref_matches_reference_fused_solver(v, k, num_steps, step, empty_row):
    """``eg_solve_ref`` (the plain version of the one-launch solve, and the
    CPU route of ``solve_p1_all_fused``) against the reference's fused solver
    with its Pallas eg_step in interpret mode: a row with no contact is 0 in
    both."""
    s, g, c = _p1_case(v, k, v * 31 + num_steps, empty_row)
    want = np.asarray(ref_kl.solve_p1_all_fused(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(c), num_steps=num_steps,
        step_size=step, interpret=True))
    got = kl_simplex.eg_solve_ref(T(s), T(g), T(c), num_steps=num_steps, step_size=step)
    assert got.dtype == torch.float32 and got.shape == (v, v)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.numpy()[c == 0] == 0).all()
    if empty_row:
        assert (want[1] == 0).all() and (got.numpy()[1] == 0).all()
    rows = got.numpy().sum(1)[c.sum(1) > 0]
    np.testing.assert_allclose(rows, 1.0, atol=1e-5)
    fused = kl_simplex.solve_p1_all_fused(T(s), T(g), T(c), num_steps=num_steps,
                                          step_size=step)
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


def test_eg_solve_ref_is_the_loop_over_eg_step_ref():
    """No contact-free row: the plain solve is exactly ``num_steps`` calls of
    ``eg_step_ref`` between the two full-f32 products."""
    s, g, c = _p1_case(10, 14, 4, empty_row=False)
    alpha = T(c) / T(c).sum(1, keepdim=True)
    for _ in range(25):
        u = torch.clamp(alpha @ T(s), min=1e-12)
        grad = (torch.log(u) - torch.log(torch.clamp(T(g), min=1e-12)) + 1.0) @ T(s).T
        alpha = kl_simplex.eg_step_ref(alpha, grad, T(c), step_size=2.0)
    got = kl_simplex.eg_solve_ref(T(s), T(g), T(c), num_steps=25)
    np.testing.assert_array_equal(got.numpy(), alpha.numpy())
    zero = kl_simplex.eg_solve_ref(T(s), T(g), T(c), num_steps=0)
    np.testing.assert_array_equal(zero.numpy(), (T(c) / T(c).sum(1, keepdim=True)).numpy())


def _scipy_optimum(s, g, mask):
    """P1's optimum in nats by SLSQP over the contact set (as
    tests/test_kl_solver.py finds it for the reference)."""
    k = len(g)
    idx = np.where(mask)[0]

    def f(a_active):
        a = np.zeros(k)
        a[idx] = a_active
        u = a @ s
        return float(np.sum(np.where(
            u > 1e-12, u * (np.log(np.clip(u, 1e-12, 1)) - np.log(np.clip(g, 1e-12, 1))), 0)))

    res = minimize(f, np.ones(len(idx)) / len(idx), bounds=[(0, 1)] * len(idx),
                   constraints=({"type": "eq", "fun": lambda a: a.sum() - 1},),
                   method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
    return res.fun


@pytest.mark.parametrize("solver", ["solve_p1", "solve_p1_all", "solve_p1_all_fused"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_solvers_reach_the_scipy_optimum(seed, solver):
    """The port's P1 solvers on the CPU (the single-row solve, the batched
    one, the fused entry point's plain route) within 5e-5 nats of SLSQP's
    optimum, the reference's own bound; rows 0 and 1 of a contact matrix."""
    r = np.random.default_rng(seed)
    k = int(r.integers(4, 20))
    s = r.dirichlet(np.ones(k) * r.uniform(0.3, 4), size=k).astype(np.float32)
    g = r.dirichlet(np.ones(k) * r.uniform(0.5, 8)).astype(np.float32)
    c = np.zeros((k, k), np.float32)
    for i in range(k):
        c[i, r.choice(k, size=int(r.integers(2, k + 1)), replace=False)] = 1.0
    if solver == "solve_p1":
        alphas = [kl_solver.solve_p1(T(s), T(g), T(c[i])) for i in (0, 1)]
    elif solver == "solve_p1_all":
        alphas = list(kl_solver.solve_p1_all(T(s), T(g), T(c))[:2])
    else:
        alphas = list(kl_simplex.solve_p1_all_fused(T(s), T(g), T(c))[:2])
    for i, alpha in enumerate(alphas):
        assert (alpha.numpy()[c[i] == 0] == 0).all()
        eg = float(kl_solver.kl_objective(alpha, T(s), T(g)))
        sp = _scipy_optimum(s, g, c[i])
        assert eg - sp < 5e-5, (i, eg, sp)
