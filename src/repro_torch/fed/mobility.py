"""Mobility models over a RoadNetwork, behind a string-keyed registry.

The paper's process is Manhattan mobility [34]: vehicles travel along edges
at (roughly) constant speed; at each junction they turn with the Manhattan
probabilities — straight 0.5, left 0.25, right 0.25 — generalized to
arbitrary junction degrees: the edge most opposite the incoming direction
gets probability 0.5 and the remainder is split evenly (dead ends force a
U-turn). Positions are advanced in continuous time; one snapshot per global
DFL epoch yields the time-varying contact graphs the learning layer
consumes.

New mobility processes register a factory and are addressable by name from
``SimulationConfig.mobility`` with no engine edits; a model only needs
``advance_positions(num_epochs) -> [T, K, 2]`` (and must consume its RNG
epoch by epoch so trajectories are invariant to window chunking):

    @register_mobility("waypoint")
    class RandomWaypoint: ...
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .topology import RoadNetwork, contact_matrices, contact_matrix

_MOBILITY_MODELS: dict[str, Callable] = {}


def register_mobility(name: str):
    """Register ``factory(net: RoadNetwork, cfg: MobilityConfig)`` under
    ``name``. Decorator; returns the factory unchanged."""

    def deco(factory: Callable):
        _MOBILITY_MODELS[name] = factory
        return factory

    return deco


def available_mobility_models() -> list[str]:
    return sorted(_MOBILITY_MODELS)


def mobility_registry() -> dict[str, Callable]:
    """Snapshot of the registry (name -> factory), for the docs tables."""
    return dict(_MOBILITY_MODELS)


def make_mobility(name: str, net: RoadNetwork, cfg: "MobilityConfig"):
    """Build a registered mobility process by name."""
    try:
        factory = _MOBILITY_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown mobility model {name!r} "
            f"(registered: {'|'.join(available_mobility_models())})") from None
    return factory(net, cfg)


@dataclass
class MobilityConfig:
    num_vehicles: int = 100
    speed: float = 13.89          # m/s (paper default velocity)
    speed_jitter: float = 0.2     # +-20% per-vehicle speed factor (congestion proxy)
    epoch_duration: float = 30.0  # seconds of motion per global epoch
    comm_range: float = 100.0     # meters (paper)
    seed: int = 0


@register_mobility("manhattan")
class ManhattanMobility:
    """Paper Manhattan mobility: straight 0.5 / left 0.25 / right 0.25 turns.

    Stateful process; ``advance_positions(T)`` yields the engine's [T, K, 2]
    snapshots, ``step()`` one epoch's [K, K] contact matrix."""

    def __init__(self, net: RoadNetwork, cfg: MobilityConfig):
        self.net = net
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        k = cfg.num_vehicles
        # each vehicle: current edge (u -> v) and fractional progress in [0, 1)
        self.src = self.rng.integers(0, net.num_nodes, size=k)
        self.dst = np.array([self._random_neighbour(int(u)) for u in self.src])
        self.frac = self.rng.uniform(0, 1, size=k)
        self.speed = cfg.speed * (1 + self.rng.uniform(-cfg.speed_jitter, cfg.speed_jitter, size=k))

    def _random_neighbour(self, u: int) -> int:
        nbrs = self.net.adjacency[u]
        return int(nbrs[self.rng.integers(0, len(nbrs))])

    def _turn(self, prev: int, junction: int) -> int:
        """Manhattan turn choice at ``junction`` arriving from ``prev``."""
        nbrs = [v for v in self.net.adjacency[junction]]
        if len(nbrs) == 1:
            return nbrs[0]  # dead end: U-turn
        fwd = [v for v in nbrs if v != prev]
        # 'straight' = the outgoing edge with direction closest to incoming
        p_in = self.net.positions[junction] - self.net.positions[prev]
        ang_in = math.atan2(p_in[1], p_in[0])

        def deviation(v):
            p_out = self.net.positions[v] - self.net.positions[junction]
            a = math.atan2(p_out[1], p_out[0]) - ang_in
            return abs((a + math.pi) % (2 * math.pi) - math.pi)

        fwd.sort(key=deviation)
        straight = fwd[0]
        if len(fwd) == 1:
            return straight
        if self.rng.random() < 0.5:
            return straight
        rest = fwd[1:]
        return int(rest[self.rng.integers(0, len(rest))])

    def positions(self) -> np.ndarray:
        p_src = self.net.positions[self.src]
        p_dst = self.net.positions[self.dst]
        return p_src + self.frac[:, None] * (p_dst - p_src)

    def _advance_epoch(self) -> None:
        """Advance every vehicle by ``epoch_duration`` seconds of motion."""
        remaining = self.speed * self.cfg.epoch_duration
        remaining = remaining.copy()
        for k in range(self.cfg.num_vehicles):
            while remaining[k] > 0:
                u, v = int(self.src[k]), int(self.dst[k])
                length = max(self.net.edge_length(u, v), 1e-6)
                left = (1.0 - self.frac[k]) * length
                if remaining[k] < left:
                    self.frac[k] += remaining[k] / length
                    remaining[k] = 0.0
                else:
                    remaining[k] -= left
                    nxt = self._turn(u, v)
                    self.src[k], self.dst[k] = v, nxt
                    self.frac[k] = 0.0

    def advance_positions(self, num_epochs: int) -> np.ndarray:
        """Advance ``num_epochs`` epochs; return the [T, K, 2] position
        snapshots (one per epoch). The motion process is inherently
        sequential, but collecting a window of snapshots up front lets the
        distance -> contact conversion run batched (topology.contact_matrices)
        and feeds the fused scan engine one [T, K, K] tensor per window."""
        out = np.empty((num_epochs, self.cfg.num_vehicles, 2), dtype=np.float64)
        for t in range(num_epochs):
            self._advance_epoch()
            out[t] = self.positions()
        return out

    def step(self) -> np.ndarray:
        """Advance ``epoch_duration`` seconds; return the contact matrix."""
        self._advance_epoch()
        return contact_matrix(self.positions(), self.cfg.comm_range)


def contact_schedule(net: RoadNetwork, cfg: MobilityConfig, num_epochs: int) -> np.ndarray:
    """Pre-generate [T, K, K] contact matrices for ``num_epochs`` rounds."""
    mob = ManhattanMobility(net, cfg)
    return contact_matrices(mob.advance_positions(num_epochs), cfg.comm_range)
