"""Port vs reference, the deterministic core: contacts, state vectors,
aggregation and the P1 solver. The same numpy inputs go through the JAX
function and its torch counterpart on the CPU.

Tolerances: elementwise f32 code agrees to rounding (atol 1e-6); the P1
solver iterates exp/log/softmax tens of times, where the two libraries'
transcendental functions differ in the last bit, so alpha and the objective
are held to atol 1e-5 (the tolerance the reference's own kernel tests use).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.core import contacts as ref_contacts
from repro.core import kl_solver as ref_kl
from repro.core import state_vector as ref_sv
from repro.fed import topology as ref_topo
from repro_torch.core import aggregation as agg
from repro_torch.core import contacts
from repro_torch.core import kl_solver as kl
from repro_torch.core import state_vector as sv

T = torch.as_tensor


def _graph(k, seed, density=0.35):
    """Symmetric 0/1 contacts with self-loops + its neighbour lists."""
    r = np.random.default_rng(seed)
    c = np.triu(r.random((k, k)) < density, 1)
    c = (c | c.T | np.eye(k, dtype=bool)).astype(np.float32)
    d = ref_topo.max_contact_degree(c) + 1          # one padding slot
    idx, mask = ref_topo.neighbour_lists(c, d)
    return c, idx, mask


def _states(k, seed):
    r = np.random.default_rng(seed + 100)
    s = r.dirichlet(np.ones(k) * 0.5, size=k).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0                    # exact zeros on a column
    s = s / s.sum(1, keepdims=True)
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    return s, g


# ------------------------------------------------------------- contacts ----

@pytest.mark.parametrize("k,seed", [(6, 0), (17, 1)])
def test_contacts_primitives(k, seed):
    c, idx, mask = _graph(k, seed)
    r = np.random.default_rng(seed)
    sc_ref = ref_contacts.SparseContacts(jnp.asarray(idx), jnp.asarray(mask))
    sc = contacts.SparseContacts(T(idx), T(mask))
    np.testing.assert_array_equal(np.asarray(ref_contacts.self_slots(sc_ref)),
                                  contacts.self_slots(sc).numpy())
    assert float(ref_contacts.count_edges(sc_ref)) == float(contacts.count_edges(sc))
    assert float(ref_contacts.count_edges(jnp.asarray(c))) == float(contacts.count_edges(T(c)))
    assert float(contacts.count_edges(sc)) == float(contacts.count_edges(T(c)))
    assert sc.idx.shape[-1] == ref_contacts.num_slots(sc_ref)

    w = (r.random(idx.shape).astype(np.float32)) * mask
    x = r.normal(size=(k, 3, 5)).astype(np.float32)
    y = r.normal(size=(k,)).astype(np.float32)
    mix_ref = ref_contacts.SparseMixing(jnp.asarray(idx), jnp.asarray(w))
    mix = contacts.SparseMixing(T(idx), T(w))
    np.testing.assert_allclose(
        contacts.sparse_mix_array(mix, T(x)).numpy(),
        np.asarray(ref_contacts.sparse_mix_array(mix_ref, jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        contacts.mix_vector(mix, T(y)).numpy(),
        np.asarray(ref_contacts.mix_vector(mix_ref, jnp.asarray(y))), atol=1e-6)
    dense_w = ref_contacts.mixing_to_dense(mix_ref)
    np.testing.assert_array_equal(contacts.mixing_to_dense(mix), dense_w)
    np.testing.assert_allclose(
        contacts.mix_vector(T(dense_w), T(y)).numpy(),
        contacts.mix_vector(mix, T(y)).numpy(), atol=1e-6)
    pa = ref_contacts.pad_slots(ref_contacts.SparseContacts(idx, mask), idx.shape[1] + 3)
    pb = contacts.pad_slots(sc, idx.shape[1] + 3)
    np.testing.assert_array_equal(pa.idx, pb.idx)
    np.testing.assert_array_equal(pa.mask, pb.mask)
    with pytest.raises(ValueError):
        contacts.pad_slots(sc, 1)


def test_contact_format_registry_matches():
    assert contacts.available_contact_formats() == ref_contacts.available_contact_formats()
    for name in contacts.available_contact_formats():
        assert (contacts.get_contact_format(name).sparse
                == ref_contacts.get_contact_format(name).sparse)
    with pytest.raises(ValueError):
        contacts.get_contact_format("csr")


# --------------------------------------------------------- state vector ----

@pytest.mark.parametrize("k,seed", [(5, 0), (23, 2)])
def test_state_vector_functions(k, seed):
    s, g = _states(k, seed)
    c, idx, mask = _graph(k, seed)
    w = c / c.sum(1, keepdims=True)
    um = (np.arange(k) < k - 2).astype(np.float32)
    pairs = [
        (ref_sv.entropy(jnp.asarray(s)), sv.entropy(T(s))),
        (ref_sv.kl_to_target(jnp.asarray(s), jnp.asarray(g)), sv.kl_to_target(T(s), T(g))),
        (ref_sv.normalize(jnp.asarray(s * 3)), sv.normalize(T(s * 3))),
        (ref_sv.normalize(jnp.zeros((k, k))), sv.normalize(torch.zeros(k, k))),
        (ref_sv.local_update(jnp.asarray(s), 0.1, 8), sv.local_update(T(s), 0.1, 8)),
        (ref_sv.local_update(ref_sv.init_state(k), 0.1, 8, update_mask=jnp.asarray(um)),
         sv.local_update(sv.init_state(k), 0.1, 8, update_mask=T(um))),
        (ref_sv.aggregate(jnp.asarray(s), jnp.asarray(w)), sv.aggregate(T(s), T(w))),
        (ref_sv.target_state(jnp.arange(1, k + 1)), sv.target_state(np.arange(1, k + 1))),
    ]
    ws = (w[np.arange(k)[:, None], idx] * mask).astype(np.float32)
    pairs.append((
        ref_sv.aggregate(jnp.asarray(s), ref_contacts.SparseMixing(jnp.asarray(idx), jnp.asarray(ws))),
        sv.aggregate(T(s), contacts.SparseMixing(T(idx), T(ws)))))
    for ref, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # bits, not nats: the uniform distribution over k sources has log2(k) bits
    assert abs(float(sv.entropy(torch.full((1, k), 1.0 / k))[0]) - np.log2(k)) < 1e-5


# ----------------------------------------------------------- aggregation ----

@pytest.mark.parametrize("k,seed", [(6, 0), (19, 3)])
def test_aggregation_functions(k, seed):
    c, idx, mask = _graph(k, seed)
    r = np.random.default_rng(seed)
    alpha = r.random((k, k)).astype(np.float32)
    alpha_s = r.random(idx.shape).astype(np.float32)
    sc_ref = ref_contacts.SparseContacts(jnp.asarray(idx), jnp.asarray(mask))
    sc = contacts.SparseContacts(T(idx), T(mask))
    np.testing.assert_allclose(
        agg.mixing_from_alpha(T(alpha), T(c)).numpy(),
        np.asarray(ref_agg.mixing_from_alpha(jnp.asarray(alpha), jnp.asarray(c))), atol=1e-6)
    m_ref = ref_agg.mixing_from_alpha(jnp.asarray(alpha_s), sc_ref)
    m = agg.mixing_from_alpha(T(alpha_s), sc)
    np.testing.assert_allclose(m.w.numpy(), np.asarray(m_ref.w), atol=1e-6)
    np.testing.assert_array_equal(m.idx.numpy(), np.asarray(m_ref.idx))
    np.testing.assert_allclose(agg.uniform_mixing(T(c)).numpy(),
                               np.asarray(ref_agg.uniform_mixing(jnp.asarray(c))), atol=1e-6)
    np.testing.assert_allclose(agg.uniform_mixing(sc).w.numpy(),
                               np.asarray(ref_agg.uniform_mixing(sc_ref).w), atol=1e-6)

    tree = {"a": r.normal(size=(k, 3, 4)).astype(np.float32),
            "b": r.normal(size=(k, 11)).astype(np.float32)}
    tree_ref = {n: jnp.asarray(v) for n, v in tree.items()}
    tree_t = {n: T(v) for n, v in tree.items()}
    w = np.array(ref_agg.uniform_mixing(jnp.asarray(c)))
    for mix_ref, mix in ((jnp.asarray(w), T(w)), (m_ref, m)):
        want = ref_agg.mix_params(mix_ref, tree_ref)
        got = agg.mix_params(mix, tree_t)
        for n in tree:
            assert got[n].shape == tree[n].shape and got[n].dtype == torch.float32
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), atol=1e-6)
    np.testing.assert_allclose(
        float(agg.consensus_distance(tree_t)),
        float(ref_agg.consensus_distance(tree_ref)), rtol=1e-6)
    # bf16 leaves: f32 accumulate, cast back to the leaf's dtype
    xb = T(tree["b"]).to(torch.bfloat16)
    got = agg.mix_params(T(w), {"b": xb})["b"]
    want = ref_agg.mix_params(jnp.asarray(w), {"b": jnp.asarray(tree["b"], jnp.bfloat16)})["b"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2)


# ------------------------------------------------------------- P1 solver ----

@pytest.mark.parametrize("k,seed,steps", [(8, 0, 40), (20, 1, 60)])
def test_solve_p1_all_dense_and_sparse(k, seed, steps, monkeypatch):
    s, g = _states(k, seed)
    c, idx, mask = _graph(k, seed)
    sc_ref = ref_contacts.SparseContacts(jnp.asarray(idx), jnp.asarray(mask))
    sc = contacts.SparseContacts(T(idx), T(mask))

    want = np.asarray(ref_kl.solve_p1_all(jnp.asarray(s), jnp.asarray(g), jnp.asarray(c),
                                          num_steps=steps, step_size=2.0))
    got = kl.solve_p1_all(T(s), T(g), T(c), num_steps=steps, step_size=2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(got.numpy()[c == 0] == 0.0)          # exactly zero off the mask
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    obj_ref = np.asarray([ref_kl.kl_objective(jnp.asarray(want[i]), jnp.asarray(s), jnp.asarray(g))
                          for i in range(k)])
    np.testing.assert_allclose(kl.kl_objective(got, T(s), T(g)).numpy(), obj_ref, atol=1e-5)

    want_s = np.asarray(ref_kl.solve_p1_all(jnp.asarray(s), jnp.asarray(g), sc_ref,
                                            num_steps=steps, step_size=2.0))
    got_s = kl.solve_p1_all(T(s), T(g), sc, num_steps=steps, step_size=2.0)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-5)
    assert np.all(got_s.numpy()[mask == 0] == 0.0)
    # per-row objective of the slot solution, against the gathered states
    gathered = T(s)[T(idx).long()]
    np.testing.assert_allclose(
        kl.kl_objective(got_s, gathered, T(g)).numpy(), obj_ref, atol=1e-5)
    # sparse and dense land on the same weights, edge for edge
    np.testing.assert_allclose(
        contacts.mixing_to_dense(contacts.SparseMixing(T(idx), got_s)),
        got.numpy(), atol=1e-5)

    # the blocked path: 3-row blocks, the last one ragged
    monkeypatch.setattr(kl, "P1_BLOCK", 3)
    blocked = kl.solve_p1_all(T(s), T(g), sc, num_steps=steps, step_size=2.0)
    assert blocked.shape == got_s.shape
    np.testing.assert_allclose(blocked.numpy(), got_s.numpy(), atol=1e-6)
    np.testing.assert_allclose(blocked.numpy(), want_s, atol=1e-5)


def test_solve_p1_single_vehicle_and_optimum():
    k = 9
    s, g = _states(k, 4)
    c, _, _ = _graph(k, 4)
    want = np.asarray(ref_kl.solve_p1(jnp.asarray(s), jnp.asarray(g), jnp.asarray(c[2]),
                                      num_steps=50, step_size=2.0))
    got = kl.solve_p1(T(s), T(g), T(c[2]), num_steps=50, step_size=2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # EG descends: more steps never end above the uniform start
    start = T(c[2] / c[2].sum())
    assert float(kl.kl_objective(got, T(s), T(g))) <= float(kl.kl_objective(start, T(s), T(g))) + 1e-6
