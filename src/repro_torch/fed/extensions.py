"""Paper extensions implemented as first-class features.

* RSUs (paper Sec. V-C): road-side units are static participants that hold
  no data — they maintain state vectors and relay aggregated models, giving
  poorly-connected vehicles more mixing opportunities. An RSU never runs
  local iterations (Eq. 5 must not bump a data-less participant), and the
  target vector g gives it zero weight (n_rsu = 0).

* Unreliable communication (paper Sec. VII future work): V2V exchanges fail
  independently with probability p_drop; a failed exchange removes BOTH
  directions of the contact edge for that round (the paper's synchronous
  model exchanges are bidirectional). Self-loops never fail.
"""
from __future__ import annotations

import numpy as np

from .topology import (RoadNetwork, contact_matrices, contact_matrix,
                       neighbour_lists)


def place_rsus(net: RoadNetwork, num_rsus: int, seed: int = 0) -> np.ndarray:
    """RSU positions at the highest-degree junctions (deterministic given the
    network; ties broken by node index)."""
    deg = net.degrees()
    order = np.lexsort((np.arange(net.num_nodes), -deg))
    return net.positions[order[:num_rsus]].copy()


def contacts_with_rsus(vehicle_positions: np.ndarray, rsu_positions: np.ndarray,
                       comm_range: float = 100.0) -> np.ndarray:
    """[K+R, K+R] contact matrix over vehicles followed by RSUs."""
    pos = np.concatenate([vehicle_positions, rsu_positions], axis=0)
    return contact_matrix(pos, comm_range)


def rsu_local_step_mask(num_vehicles: int, num_rsus: int) -> np.ndarray:
    """[K+R] — 1 for participants that run local iterations (vehicles only)."""
    return np.concatenate([np.ones(num_vehicles), np.zeros(num_rsus)]).astype(np.float32)


def drop_contacts(contacts: np.ndarray, p_drop: float, rng: np.random.Generator) -> np.ndarray:
    """Symmetric Bernoulli edge dropping; self-loops survive."""
    return drop_contacts_window(contacts[None], p_drop, rng)[0]


def drop_contacts_window(contacts: np.ndarray, p_drop: float,
                         rng: np.random.Generator) -> np.ndarray:
    """Batched ``drop_contacts`` over a [T, K, K] window.

    Consumes the SAME generator stream as T successive ``drop_contacts``
    calls (numpy Generators fill arrays sequentially), so results are
    independent of how a run is chunked into windows.
    """
    if p_drop <= 0:
        return contacts
    t, k, _ = contacts.shape
    keep = rng.random((t, k, k)) >= p_drop
    keep = np.triu(keep, 1)                     # applies to the last two dims
    keep = keep | keep.transpose(0, 2, 1)
    out = contacts * keep
    out[:, np.arange(k), np.arange(k)] = 1.0
    return out.astype(contacts.dtype)


def contact_window(positions: np.ndarray, rsu_positions: np.ndarray | None,
                   comm_range: float, p_drop: float,
                   drop_rng: np.random.Generator) -> np.ndarray:
    """[T, K, 2] vehicle position snapshots -> [T, K(+R), K(+R)] contacts.

    The batched composition of ``contacts_with_rsus`` and ``drop_contacts``:
    static RSU positions are appended to every snapshot, the whole window's
    pairwise distances are computed in one shot, then unreliable V2V edges
    are dropped. This is the host-side precompute feeding the fused engine.
    """
    if rsu_positions is not None and len(rsu_positions):
        rsus = np.broadcast_to(rsu_positions,
                               (positions.shape[0],) + rsu_positions.shape)
        positions = np.concatenate([positions, rsus], axis=1)
    contacts = contact_matrices(positions, comm_range)
    return drop_contacts_window(contacts, p_drop, drop_rng)


def neighbour_window(positions: np.ndarray, rsu_positions: np.ndarray | None,
                     comm_range: float, p_drop: float,
                     drop_rng: np.random.Generator,
                     d_max: int) -> tuple[np.ndarray, np.ndarray]:
    """``contact_window`` emitted as padded neighbour lists ``(idx, mask)``
    of shape ``[T, K(+R), d_max]`` — the sparse contact format's host-side
    precompute.

    Built one epoch at a time so peak host memory is one ``[K, K]`` matrix
    plus the ``[T, K, d_max]`` output, never the dense ``[T, K, K]`` window.
    The drop RNG is consumed epoch by epoch (``drop_contacts_window`` on
    [1, K, K] slices), so sparse and dense streams with the same seed see
    the *same* dropped edges and trajectories stay format-independent.
    Overflowing ``d_max`` raises (see ``topology.neighbour_lists``).
    """
    t = positions.shape[0]
    k = positions.shape[1] + (len(rsu_positions) if rsu_positions is not None
                              else 0)
    d_max = min(int(d_max), k)
    idx = np.empty((t, k, d_max), np.int32)
    mask = np.empty((t, k, d_max), np.float32)
    for e in range(t):
        dense = contact_window(positions[e:e + 1], rsu_positions, comm_range,
                               p_drop, drop_rng)
        idx[e], mask[e] = neighbour_lists(dense[0], d_max)
    return idx, mask
