"""Port vs reference, the kl_simplex entry point: the state diagnostics
``kl_rows`` / ``entropy_rows``, the exponentiated-gradient step and the P1
solve (``core.kl_solver.solve_p1_all`` and the plain version of its
one-launch kernel) against the reference's fused solver. The reference's
Pallas kernels run in interpret mode on the CPU; the port's ``ops`` take
their plain versions on CPU tensors. Same numpy inputs to both, atol 1e-5
(the reference's own kernel-test tolerance: the two libraries' log / exp
differ in the last bit).
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from repro.core import contacts as ref_contacts
from repro.core import kl_solver as ref_solver
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
    """``solve_p1_all`` on dense contacts against the reference's fused solver
    (its Pallas eg_step in interpret mode), alpha and the per-row objective."""
    s, g, c = _p1_inputs(20, 9)
    want = np.asarray(ref_kl.solve_p1_all_fused(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(c), num_steps=num_steps,
        step_size=step, interpret=True))
    got = kl_solver.solve_p1_all(T(s), T(g), T(c), num_steps=num_steps, step_size=step)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.numpy()[c == 0] == 0).all()
    objective = kl_solver.kl_objective(torch.tensor(want), T(s), T(g))
    np.testing.assert_allclose(kl_solver.kl_objective(got, T(s), T(g)).numpy(),
                               objective.numpy(), atol=1e-5)


def test_kl_simplex_imports_nothing_from_core():
    """The layers point one way: ``core.kl_solver`` routes the P1 solve, and
    ``kernels.kl_simplex`` (kernel, plain version, wrappers) knows no module
    of ``repro_torch.core``."""
    package = Path(kl_simplex.__file__).parent
    for path in sorted(package.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                name = "." * node.level + (node.module or "")
                assert not name.startswith("...core") and "repro_torch.core" not in name, \
                    (path.name, name)
            elif isinstance(node, ast.Import):
                assert not any(a.name.startswith("repro_torch.core") for a in node.names), \
                    path.name


def test_cuda_wrappers_refuse_cpu_tensors():
    s, g = _rows(3, 5, 0)
    a, gr, m = _eg_inputs(3, 5, 0)
    for call in (lambda: kl_simplex.kl_rows_kernel(T(s), T(g)),
                 lambda: kl_simplex.entropy_rows_kernel(T(s)),
                 lambda: kl_simplex.eg_step(T(a), T(gr), T(m)),
                 lambda: kl_simplex.eg_solve_rows(T(s), None, T(g), T(m[:, :3]).contiguous(),
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
    """``eg_solve_rows_ref`` with no id table (the plain version of the
    one-launch solve on dense contacts) against the reference's fused solver
    with its Pallas eg_step in interpret mode: a row with no contact is 0 in
    both; the identity table ``arange(D)`` on every row gives the same bits."""
    s, g, c = _p1_case(v, k, v * 31 + num_steps, empty_row)
    want = np.asarray(ref_kl.solve_p1_all_fused(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(c), num_steps=num_steps,
        step_size=step, interpret=True))
    got = kl_simplex.eg_solve_rows_ref(T(s), None, T(g), T(c), num_steps=num_steps,
                                       step_size=step)
    assert got.dtype == torch.float32 and got.shape == (v, v)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got.numpy()[c == 0] == 0).all()
    if empty_row:
        assert (want[1] == 0).all() and (got.numpy()[1] == 0).all()
    rows = got.numpy().sum(1)[c.sum(1) > 0]
    np.testing.assert_allclose(rows, 1.0, atol=1e-5)
    ids = torch.arange(v, dtype=torch.int32).expand(v, v).contiguous()
    table = kl_simplex.eg_solve_rows_ref(T(s), ids, T(g), T(c), num_steps=num_steps,
                                         step_size=step)
    np.testing.assert_array_equal(table.numpy(), got.numpy())


def test_eg_solve_ref_is_the_loop_over_eg_step_ref():
    """No contact-free row: the P1 loop (``ref.eg_iterate``, and
    ``solve_p1_all`` on CPU tensors) is exactly ``num_steps`` calls of
    ``eg_step_ref`` between the two full-f32 products."""
    s, g, c = _p1_case(10, 14, 4, empty_row=False)
    alpha = T(c) / T(c).sum(1, keepdim=True)
    for _ in range(25):
        u = torch.clamp(alpha @ T(s), min=1e-12)
        grad = (torch.log(u) - torch.log(torch.clamp(T(g), min=1e-12)) + 1.0) @ T(s).T
        alpha = kl_simplex.eg_step_ref(alpha, grad, T(c), step_size=2.0)
    got = kl_simplex.ref.eg_iterate(T(s), T(g), T(c), 25, 2.0, kl_simplex.eg_step_ref)
    np.testing.assert_array_equal(got.numpy(), alpha.numpy())
    np.testing.assert_array_equal(kl_solver.solve_p1_all(T(s), T(g), T(c), num_steps=25).numpy(),
                                  alpha.numpy())
    zero = kl_simplex.ref.eg_iterate(T(s), T(g), T(c), 0, 2.0, kl_simplex.eg_step_ref)
    np.testing.assert_array_equal(zero.numpy(), (T(c) / T(c).sum(1, keepdim=True)).numpy())


def _neighbour_case(k, seeds, seed, pad=1, empty_row=False):
    """Seeded P1 inputs on neighbour lists: states ``[S, K, K]``, targets
    ``[S, K]``, and ids / mask ``[S, K, D]`` from symmetric contacts with
    self-loops (``fed.topology.neighbour_lists``: padding slots carry the row's
    own id, mask 0), ``pad`` slots past the largest contact set; with
    ``empty_row``, row 1 of every seed has no contact at all."""
    from repro_torch.fed import topology
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k) * 0.5, size=(seeds, k)).astype(np.float32)
    s[..., r.integers(0, k)] = 0.0                  # a data source nobody holds
    s = (s / s.sum(-1, keepdims=True)).astype(np.float32)
    g = r.dirichlet(np.ones(k) * 2, size=seeds).astype(np.float32)
    cs = []
    for _ in range(seeds):
        c = np.triu(r.random((k, k)) < 0.3, 1)
        cs.append((c | c.T | np.eye(k, dtype=bool)).astype(np.float32))
    d = max(topology.max_contact_degree(c) for c in cs) + pad
    idx, mask = (np.stack(x) for x in zip(*(topology.neighbour_lists(c, d) for c in cs)))
    if empty_row:
        mask[:, 1] = 0.0
    return (T(s), T(g), T(idx.astype(np.int32)), T(mask.astype(np.float32)))


@pytest.mark.parametrize("k,seeds,pad", [(9, 1, 1), (20, 1, 3), (16, 3, 1), (7, 4, 2)])
def test_eg_solve_rows_ref_equals_the_eager_neighbour_solve(k, seeds, pad):
    """``solve_p1_all`` on neighbour lists (the loop over the gathered rows on
    CPU tensors) against the reference's ``solve_p1_all`` on the same lists,
    one run ([K, D] ids) and S runs with their seeds folded into the rows
    ([S, K, D] ids, each seed against its own target, held to that seed's
    run of the reference); and the plain version of the id-table kernel
    against it, with and without the seed axis; padding slots get 0."""
    s, g, idx, mask = _neighbour_case(k, seeds, k * 10 + seeds, pad)
    steps = 60
    run = (lambda x: x[0]) if seeds == 1 else (lambda x: x)   # one run: no seed axis
    got = kl_solver.solve_p1_all(run(s), run(g), contacts.SparseContacts(run(idx), run(mask)),
                                 num_steps=steps, step_size=2.0).reshape(mask.shape)
    assert got.dtype == torch.float32
    for i in range(seeds):
        sc = ref_contacts.SparseContacts(jnp.asarray(idx[i].numpy()), jnp.asarray(mask[i].numpy()))
        want = np.asarray(ref_solver.solve_p1_all(jnp.asarray(s[i].numpy()),
                                                  jnp.asarray(g[i].numpy()), sc,
                                                  num_steps=steps, step_size=2.0))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-5)
    rows = kl_simplex.eg_solve_rows_ref(s, idx, g, mask, num_steps=steps, step_size=2.0)
    np.testing.assert_allclose(rows.numpy(), got.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        kl_simplex.eg_solve_rows_ref(s[0], idx[0], g[0], mask[0], num_steps=steps,
                                     step_size=2.0).numpy(), got[0].numpy(), atol=1e-6)
    assert (got.numpy()[mask.numpy() == 0] == 0).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_solve_p1_all_with_a_seed_axis_on_dense_contacts_is_each_seeds_own_solve():
    """Dense contacts with a seed axis (``run_seeds``): each seed's rows are,
    bit for bit, the solve of that seed alone (its states kept shared, one
    product per seed, as a single run takes them)."""
    s, g, idx, mask = _neighbour_case(9, 3, 5)
    c = torch.stack([torch.as_tensor(contacts.mixing_to_dense(contacts.SparseMixing(i, m)) > 0)
                     for i, m in zip(idx, mask)]).to(torch.float32)
    got = kl_solver.solve_p1_all(s, g, c, num_steps=80)
    assert got.shape == c.shape
    for i in range(3):
        one = kl_solver.solve_p1_all(s[i], g[i], c[i], num_steps=80)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())
    assert (got.numpy()[c.numpy() == 0] == 0).all()


def test_eg_solve_rows_ref_gives_zero_on_an_empty_row_and_on_padding():
    """Padding slots and a row with no contact: 0, the kernel's rule; the other
    rows as the eager solve gives them (which gives NaN on the empty row)."""
    s, g, idx, mask = _neighbour_case(10, 2, 7, pad=2, empty_row=True)
    got = kl_simplex.eg_solve_rows_ref(s, idx, g, mask, num_steps=40)
    assert (got[:, 1] == 0).all() and (got.numpy()[mask.numpy() == 0] == 0).all()
    eager = kl_solver.solve_p1_all(s, g, contacts.SparseContacts(idx, mask), num_steps=40)
    assert torch.isnan(eager[:, 1]).all()
    keep = [0] + list(range(2, 10))
    np.testing.assert_allclose(got[:, keep].numpy(), eager[:, keep].numpy(), atol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "sparse", "dense_seeds", "sparse_seeds"])
def test_solve_p1_all_on_the_cpu_takes_the_eager_loop(layout):
    """On CPU tensors ``solve_p1_all`` counts one eager solve and no kernel
    solve, in every layout, and gives the loop's alpha bit for bit."""
    s, g, idx, mask = _neighbour_case(8, 2, 11)
    c = torch.as_tensor(np.stack([contacts.mixing_to_dense(contacts.SparseMixing(idx[i], mask[i]))
                                  for i in range(2)]) > 0).to(torch.float32)
    args = {"dense": (s[0], g[0], c[0]), "sparse": (s[0], g[0], contacts.SparseContacts(idx[0], mask[0])),
            "dense_seeds": (s, g, c), "sparse_seeds": (s, g, contacts.SparseContacts(idx, mask))}[layout]
    kl_solver.reset_solve_counts()
    got = kl_solver.solve_p1_all(*args, num_steps=30)
    assert kl_solver.solve_counts == {"kernel": 0, "eager": 1}
    want = kl_solver._solve_p1_loop(*args, 30, 2.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


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


@pytest.mark.parametrize("solver", ["solve_p1", "solve_p1_all", "solve_p1_all_neighbours"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_solvers_reach_the_scipy_optimum(seed, solver):
    """The port's P1 solvers on the CPU (the single-row solve, the batched
    one on a contact matrix and on its neighbour lists) within 5e-5 nats of
    SLSQP's optimum, the reference's own bound; rows 0 and 1 of a contact
    matrix."""
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
        d = int(c.sum(1).max())
        idx = np.stack([np.concatenate([np.flatnonzero(row), np.full(d, i)])[:d]
                        for i, row in enumerate(c)]).astype(np.int32)
        mask = (np.arange(d) < c.sum(1, keepdims=True)).astype(np.float32)
        slots = kl_solver.solve_p1_all(T(s), T(g), contacts.SparseContacts(T(idx), T(mask)))
        alphas = [torch.zeros(k).index_add_(0, T(idx[i]).long(), slots[i]) for i in (0, 1)]
    for i, alpha in enumerate(alphas):
        assert (alpha.numpy()[c[i] == 0] == 0).all()
        eg = float(kl_solver.kl_objective(alpha, T(s), T(g)))
        sp = _scipy_optimum(s, g, c[i])
        assert eg - sp < 5e-5, (i, eg, sp)
