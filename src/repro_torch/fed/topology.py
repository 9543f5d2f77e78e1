"""Road-network topologies (paper Sec. VI-A.3): grid, random, spider — plus
beyond-paper nets, all behind a string-keyed registry.

A road network is an undirected graph of junction nodes with 2-D positions;
vehicles move along edges (see mobility.py). This replaces the SUMO traffic
simulator (unavailable offline) — the learning system only ever consumes the
resulting time-varying contact graphs.

New scenarios register a factory and are immediately addressable by name
from ``SimulationConfig.road_net`` and the sweep runner — no engine edits:

    @register_road_network("roundabout")
    def roundabout_net(seed: int = 0) -> RoadNetwork: ...
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass
class RoadNetwork:
    name: str
    positions: np.ndarray            # [N, 2] junction coordinates (meters)
    edges: np.ndarray                # [M, 2] int junction index pairs (i < j)
    adjacency: list[list[int]] = field(default_factory=list)  # node -> neighbour nodes

    def __post_init__(self):
        if not self.adjacency:
            adj: list[list[int]] = [[] for _ in range(len(self.positions))]
            for i, j in self.edges:
                adj[int(i)].append(int(j))
                adj[int(j)].append(int(i))
            self.adjacency = adj

    @property
    def num_nodes(self) -> int:
        return len(self.positions)

    def degrees(self) -> np.ndarray:
        return np.array([len(a) for a in self.adjacency])

    def edge_length(self, i: int, j: int) -> float:
        return float(np.linalg.norm(self.positions[i] - self.positions[j]))

    def is_connected(self) -> bool:
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for v in self.adjacency[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == self.num_nodes


_ROAD_NETWORKS: dict[str, Callable[..., RoadNetwork]] = {}


def register_road_network(name: str):
    """Register ``factory(seed: int = 0) -> RoadNetwork`` under ``name``.

    Decorator; returns the factory unchanged. Re-registering a name replaces
    the previous factory (useful for test doubles).
    """

    def deco(factory: Callable[..., RoadNetwork]):
        _ROAD_NETWORKS[name] = factory
        return factory

    return deco


def available_road_networks() -> list[str]:
    return sorted(_ROAD_NETWORKS)


def grid_net(side: int = 10, spacing: float = 100.0) -> RoadNetwork:
    """side x side junctions, ``spacing`` meters apart (paper: 10x10, 100 m;
    degrees 2/3/4 with frequencies {4, 32, 64})."""
    pos = np.array([[x * spacing, y * spacing] for y in range(side) for x in range(side)], dtype=np.float64)
    edges = []
    for y in range(side):
        for x in range(side):
            n = y * side + x
            if x + 1 < side:
                edges.append((n, n + 1))
            if y + 1 < side:
                edges.append((n, n + side))
    return RoadNetwork("grid", pos, np.array(edges, dtype=np.int64))


def random_net(num_nodes: int = 100, seed: int = 0,
               min_len: float = 100.0, max_len: float = 200.0,
               max_degree: int = 5) -> RoadNetwork:
    """Random road net: junctions grown one at a time at a random distance in
    [min_len, max_len] from an existing junction (paper: 100 nodes, 100
    iterations, degrees 1..5). Connectivity is guaranteed by construction.
    """
    rng = np.random.default_rng(seed)
    pos = [np.zeros(2)]
    edges: list[tuple[int, int]] = []
    deg = [0]
    for n in range(1, num_nodes):
        while True:
            anchor = int(rng.integers(0, n))
            if deg[anchor] < max_degree:
                break
        theta = rng.uniform(0, 2 * math.pi)
        dist = rng.uniform(min_len, max_len)
        p = pos[anchor] + dist * np.array([math.cos(theta), math.sin(theta)])
        pos.append(p)
        edges.append((anchor, n))
        deg[anchor] += 1
        deg.append(1)
    # densify: add a few shortcut edges between nearby low-degree junctions
    pos_arr = np.stack(pos)
    for n in range(num_nodes):
        if deg[n] >= max_degree:
            continue
        d = np.linalg.norm(pos_arr - pos_arr[n], axis=1)
        order = np.argsort(d)
        for m in order[1:6]:
            m = int(m)
            if (d[m] <= max_len and deg[n] < max_degree and deg[m] < max_degree
                    and (min(n, m), max(n, m)) not in set(edges) and rng.random() < 0.35):
                edges.append((min(n, m), max(n, m)))
                deg[n] += 1
                deg[m] += 1
    return RoadNetwork("random", pos_arr, np.array(sorted(set(edges)), dtype=np.int64))


def spider_net(arms: int = 10, circles: int = 10, radius_inc: float = 100.0) -> RoadNetwork:
    """Spider web: ``arms`` radial spokes x ``circles`` concentric rings,
    ring radius growing by ``radius_inc`` (paper: 10, 10, 100 m -> 100 nodes).
    Nodes sit at arm/circle intersections; edges run along arms and rings.
    """
    pos = []
    for c in range(1, circles + 1):
        r = c * radius_inc
        for a in range(arms):
            th = 2 * math.pi * a / arms
            pos.append([r * math.cos(th), r * math.sin(th)])
    pos_arr = np.array(pos, dtype=np.float64)

    def node(c, a):  # c in [0, circles), a in [0, arms)
        return c * arms + (a % arms)

    edges = []
    for c in range(circles):
        for a in range(arms):
            edges.append((node(c, a), node(c, a + 1)))        # ring edge
            if c + 1 < circles:
                edges.append((node(c, a), node(c + 1, a)))    # radial edge
    edges = [(min(i, j), max(i, j)) for i, j in edges]
    return RoadNetwork("spider", pos_arr, np.array(sorted(set(edges)), dtype=np.int64))


def highway_net(num_interchanges: int = 25, segment: float = 250.0,
                separation: float = 120.0, ramp_every: int = 3) -> RoadNetwork:
    """Highway corridor (beyond-paper scenario): a long main carriageway and
    a parallel frontage road, linked by ramps at every ``ramp_every``-th
    interchange. Long and thin — contact graphs are near-chains, the
    opposite mixing regime from the well-connected grid/spider nets (gossip
    information must travel the corridor hop by hop).
    """
    main = [[i * segment, 0.0] for i in range(num_interchanges)]
    frontage = [[i * segment, separation] for i in range(num_interchanges)]
    pos = np.array(main + frontage, dtype=np.float64)
    edges = []
    for i in range(num_interchanges - 1):
        edges.append((i, i + 1))                                     # main
        edges.append((num_interchanges + i, num_interchanges + i + 1))  # frontage
    for i in range(0, num_interchanges, ramp_every):
        edges.append((i, num_interchanges + i))                      # ramp
    return RoadNetwork("highway", pos, np.array(sorted(edges), dtype=np.int64))


# paper nets (Sec. VI-A.3) + beyond-paper scenarios; only `random` consumes
# the seed — the others are deterministic layouts. Named factories (not
# lambdas) so a registry listing can surface each
# entry's one-line summary.


@register_road_network("grid")
def registered_grid(seed: int = 0) -> RoadNetwork:
    """Paper 10x10 Manhattan grid, 100 m spacing (Sec. VI-A.3)."""
    return grid_net()


@register_road_network("random")
def registered_random(seed: int = 0) -> RoadNetwork:
    """Paper random-growth net: 100 junctions, degrees 1..5, seeded."""
    return random_net(seed=seed)


@register_road_network("spider")
def registered_spider(seed: int = 0) -> RoadNetwork:
    """Paper spider web: 10 radial arms x 10 concentric rings."""
    return spider_net()


@register_road_network("highway")
def registered_highway(seed: int = 0) -> RoadNetwork:
    """Beyond-paper corridor: main + frontage roads, near-chain contacts."""
    return highway_net()


def road_network_registry() -> dict[str, Callable[..., RoadNetwork]]:
    """Snapshot of the registry (name -> factory), for the docs tables."""
    return dict(_ROAD_NETWORKS)


def make_road_network(name: str, seed: int = 0) -> RoadNetwork:
    """Build a registered road network by name (the scenario registry)."""
    try:
        factory = _ROAD_NETWORKS[name]
    except KeyError:
        raise ValueError(
            f"unknown road network {name!r} "
            f"(registered: {'|'.join(available_road_networks())})") from None
    return factory(seed=seed)


def contact_matrix(positions: np.ndarray, comm_range: float = 100.0) -> np.ndarray:
    """[K, K] 0/1 contact graph: pairs within ``comm_range`` meters; diag = 1."""
    return contact_matrices(positions[None], comm_range)[0]


def contact_matrices(positions: np.ndarray, comm_range: float = 100.0) -> np.ndarray:
    """Batched ``contact_matrix``: [T, K, 2] positions -> [T, K, K] contacts.

    One vectorized distance computation for a whole epoch window — the
    host-side half of the fused engine's contact-window precompute.
    """
    d = np.linalg.norm(positions[:, :, None, :] - positions[:, None, :, :], axis=-1)
    c = (d <= comm_range).astype(np.float32)
    k = c.shape[-1]
    c[:, np.arange(k), np.arange(k)] = 1.0
    return c


def max_contact_degree(contacts: np.ndarray) -> int:
    """Largest contact-set size (including self) over a dense [..., K, K]
    window — the exact neighbour-slot demand of its sparse conversion."""
    return int(contacts.sum(axis=-1).max())


def neighbour_lists(contacts: np.ndarray, d_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense 0/1 contacts ``[..., K, K]`` -> padded neighbour lists
    ``(idx, mask)`` of shape ``[..., K, min(d_max, K)]``.

    Per row, real contacts land first in ascending neighbour-id order
    (stable argsort), then padding slots carrying the row's OWN id with mask
    0 — so gathers through padding are in-bounds no-ops. Raises a loud
    ``ValueError`` when any row holds more contacts than slots: silent
    truncation would change trajectories, so overflow is an error and the
    fix is a bigger ``d_max`` / ``contact_density`` (or the auto probe,
    which sizes D_max from the exact contact stream).
    """
    k = contacts.shape[-1]
    d_max = min(int(d_max), k)
    deg = contacts.sum(axis=-1)
    if deg.max() > d_max:
        where = np.unravel_index(int(deg.argmax()), deg.shape)
        raise ValueError(
            f"neighbour-list overflow: contact set of size {int(deg.max())} "
            f"at index {where} exceeds d_max={d_max} slots; raise "
            f"SimulationConfig.d_max / contact_density (or leave both unset "
            f"for the exact auto probe) instead of truncating contacts")
    # stable argsort of -contacts: real contacts (value 1) first, each group
    # in ascending neighbour-id order
    order = np.argsort(-contacts, axis=-1, kind="stable")[..., :d_max]
    mask = np.take_along_axis(contacts, order, axis=-1) > 0
    rows = np.arange(k).reshape((1,) * (contacts.ndim - 2) + (k, 1))
    idx = np.where(mask, order, rows)
    return idx.astype(np.int32), mask.astype(np.float32)


def dense_from_neighbours(idx: np.ndarray, mask: np.ndarray,
                          num_cols: int | None = None) -> np.ndarray:
    """Invert ``neighbour_lists``: scatter ``[..., K, D]`` lists back to the
    dense ``[..., K, K]`` 0/1 matrix (padding slots scatter zeros)."""
    k = idx.shape[-2]
    out = np.zeros(idx.shape[:-1] + (num_cols or k,), np.float32)
    flat = out.reshape(-1, out.shape[-1])
    np.add.at(flat, (np.arange(flat.shape[0])[:, None],
                     idx.reshape(-1, idx.shape[-1]).astype(np.int64)),
              mask.reshape(-1, mask.shape[-1]).astype(np.float32))
    return np.minimum(flat.reshape(out.shape), 1.0)
