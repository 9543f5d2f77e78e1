"""Plain reference of a DFL-DDS federation of the paper's MNIST CNN.

Written from the paper (arXiv 2209.01750, Alg. 1, Eqs. 3 and 5-11) and the
configuration's settings, with plain PyTorch and numpy only: it imports
nothing of the program. Where the program draws from seeded generators (the
road network's motion, the data partition, the minibatch picks, the dropout
masks, the initial weights of a ``run_seeds`` federation) the reference makes
the same draws in the same order from generators seeded alike, so both sides
see the same data; every value the program derives from them (contacts,
aggregation weights, mixed models, trained models, state vectors, accuracy)
is worked out here again.

* road network: the 10 x 10 grid of junctions 100 m apart; Manhattan
  mobility (straight 0.5, the other ways share 0.5), one snapshot per epoch;
  a contact wherever two vehicles are within range (dense ``[K, K]``).
* P1 (Eq. 11): exponentiated gradient over each vehicle's contact set,
  ``num_steps`` steps with the step normalised by the active gradient range.
* mix (Eq. 10), E SGD steps per vehicle (Eq. 3), state vectors (Eqs. 5-7),
  KL to the target and entropy in bits (Eqs. 8-9).
* the CNN (Sec. VI-A.2) as grouped ``conv2d`` over the vehicles, HWIO
  weights and an NHWC flatten before ``fc1``, dropout 0.5 after ``fc1``.

``precision="f32"`` turns TF32 off for matmuls and cuDNN; ``"tf32"`` turns it
on: the control of the comparison.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-12
EVAL_CHUNK = 250


# ---------------------------------------------------------- precision -----

@contextlib.contextmanager
def precision(mode: str):
    """``f32``: matmuls and convolutions in full f32; ``tf32``: in TF32."""
    tf32 = {"f32": False, "tf32": True}[mode]
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# ------------------------------------------------------- road network -----

class Grid:
    """``side`` x ``side`` junctions ``spacing`` metres apart; edges to the
    right and upwards neighbour, adjacency in the order the edges are laid."""

    def __init__(self, side: int = 10, spacing: float = 100.0):
        self.pos = np.array([[x * spacing, y * spacing]
                             for y in range(side) for x in range(side)], dtype=np.float64)
        self.adj = [[] for _ in range(side * side)]
        for y in range(side):
            for x in range(side):
                n = y * side + x
                for m in ([n + 1] if x + 1 < side else []) + ([n + side] if y + 1 < side else []):
                    self.adj[n].append(m)
                    self.adj[m].append(n)


class Manhattan:
    """Vehicles moving along the grid's roads at a constant speed each
    (13.89 m/s, +-20 %); at a junction: straight on with probability 0.5,
    else one of the other ways (a U-turn only at a dead end)."""

    def __init__(self, grid: Grid, num_vehicles: int, epoch_s: float, seed: int,
                 speed: float = 13.89, jitter: float = 0.2):
        self.g, self.k, self.epoch_s = grid, num_vehicles, epoch_s
        self.rng = np.random.default_rng(seed)
        n = len(grid.pos)
        self.src = self.rng.integers(0, n, size=num_vehicles)
        self.dst = np.array([self._any_way(int(u)) for u in self.src])
        self.frac = self.rng.uniform(0, 1, size=num_vehicles)
        self.speed = speed * (1 + self.rng.uniform(-jitter, jitter, size=num_vehicles))

    def _any_way(self, u: int) -> int:
        ways = self.g.adj[u]
        return int(ways[self.rng.integers(0, len(ways))])

    def _turn(self, prev: int, at: int) -> int:
        ways = list(self.g.adj[at])
        if len(ways) == 1:
            return ways[0]
        ahead = [v for v in ways if v != prev]
        d_in = self.g.pos[at] - self.g.pos[prev]
        heading = math.atan2(d_in[1], d_in[0])

        def bend(v):
            d_out = self.g.pos[v] - self.g.pos[at]
            a = math.atan2(d_out[1], d_out[0]) - heading
            return abs((a + math.pi) % (2 * math.pi) - math.pi)

        ahead.sort(key=bend)
        if len(ahead) == 1 or self.rng.random() < 0.5:
            return ahead[0]
        rest = ahead[1:]
        return int(rest[self.rng.integers(0, len(rest))])

    def step(self) -> np.ndarray:
        """Move ``epoch_s`` seconds; return the ``[K, 2]`` positions."""
        left = self.speed * self.epoch_s
        for k in range(self.k):
            while left[k] > 0:
                u, v = int(self.src[k]), int(self.dst[k])
                length = max(float(np.linalg.norm(self.g.pos[u] - self.g.pos[v])), 1e-6)
                to_go = (1.0 - self.frac[k]) * length
                if left[k] < to_go:
                    self.frac[k] += left[k] / length
                    left[k] = 0.0
                else:
                    left[k] -= to_go
                    self.src[k], self.dst[k] = v, self._turn(u, v)
                    self.frac[k] = 0.0
        a, b = self.g.pos[self.src], self.g.pos[self.dst]
        return a + self.frac[:, None] * (b - a)


def contacts_of(positions: np.ndarray, comm_range: float) -> np.ndarray:
    """``[K, K]`` 0/1: pairs within ``comm_range`` metres, and every vehicle
    with itself."""
    d = np.linalg.norm(positions[:, None, :] - positions[None, :, :], axis=-1)
    c = (d <= comm_range).astype(np.float32)
    np.fill_diagonal(c, 1.0)
    return c


def contact_stream(cfg: dict, seed: int, epochs: int) -> np.ndarray:
    """``[T, K, K]`` contacts of a federation's first ``epochs`` epochs."""
    mob = Manhattan(Grid(), cfg["num_vehicles"], cfg["epoch_duration"], seed)
    return np.stack([contacts_of(mob.step(), cfg["comm_range"]) for _ in range(epochs)])


# -------------------------------------------------------------- data ------

def partition(labels: np.ndarray, num_vehicles: int, seed: int,
              shards_per_vehicle: int = 4) -> np.ndarray:
    """Balanced non-IID split (Sec. VI-A.4): samples sorted by label, cut
    into ``shards_per_vehicle * K`` shards, ``shards_per_vehicle`` drawn per
    vehicle. Returns the ``[K, n]`` sample ids (equal sizes)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = num_vehicles * shards_per_vehicle
    usable = (len(order) // shards) * shards
    pieces = np.split(order[:usable], shards)
    perm = rng.permutation(shards)
    return np.stack([np.concatenate([pieces[s] for s in perm[k * shards_per_vehicle:
                                                               (k + 1) * shards_per_vehicle]])
                     for k in range(num_vehicles)])


def cnn_init_drawn(seed: int) -> dict:
    """The initial weights a seeded federation draws for itself when none
    are handed to it: Glorot normal from a CPU ``torch.Generator`` seeded
    with the federation's seed, in the order conv1, conv2, fc1, fc2."""
    g = torch.Generator().manual_seed(seed)

    def glorot(shape):
        scale = math.sqrt(2.0 / (math.prod(shape[:-1]) + shape[-1]))
        return scale * torch.randn(shape, generator=g, dtype=torch.float32)

    out = {}
    for name, shape in (("conv1", (5, 5, 1, 10)), ("conv2", (5, 5, 10, 20)),
                        ("fc1", (320, 50)), ("fc2", (50, 10))):
        out[f"{name}_w"] = glorot(shape)
        out[f"{name}_b"] = torch.zeros(shape[-1])
    return out


# --------------------------------------------------------------- CNN ------

def cnn_forward(p: dict, x: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """Stacked MNIST CNN: ``x`` ``[K, N, 28, 28, 1]``, weights ``[K, ...]``
    (HWIO) -> log-probabilities ``[K, N, 10]``. ``keep`` is the dropout keep
    mask ``[K, N, 50]`` (None: no dropout)."""
    k, n = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(n, k, 28, 28)
    w1 = p["conv1_w"].permute(0, 4, 3, 1, 2).reshape(k * 10, 1, 5, 5)
    h = torch.relu(F.max_pool2d(F.conv2d(h, w1, p["conv1_b"].reshape(-1), groups=k), 2))
    w2 = p["conv2_w"].permute(0, 4, 3, 1, 2).reshape(k * 20, 10, 5, 5)
    h = torch.relu(F.max_pool2d(F.conv2d(h, w2, p["conv2_b"].reshape(-1), groups=k), 2))
    h = h.reshape(n, k, 20, 4, 4).permute(1, 0, 3, 4, 2).reshape(k, n, 320)
    h = torch.relu(torch.bmm(h, p["fc1_w"]) + p["fc1_b"][:, None])
    if keep is not None:
        h = torch.where(keep, h / 0.5, torch.zeros((), device=h.device))
    return torch.log_softmax(torch.bmm(h, p["fc2_w"]) + p["fc2_b"][:, None], dim=-1)


def accuracy(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[K]`` share of ``x`` (``[N, 28, 28, 1]``, shared) each model gets right."""
    k = p["conv1_w"].shape[0]
    right = torch.zeros(k, device=x.device)
    with torch.no_grad():
        for s in range(0, x.shape[0], EVAL_CHUNK):
            xs, ys = x[s:s + EVAL_CHUNK], y[s:s + EVAL_CHUNK]
            pred = cnn_forward(p, xs.expand((k,) + tuple(xs.shape)), None).argmax(-1)
            right += (pred == ys).float().sum(-1)
    return right / x.shape[0]


# ---------------------------------------------------------------- P1 ------

def solve_p1(states: torch.Tensor, target: torch.Tensor, contacts: torch.Tensor,
             num_steps: int, step: float) -> torch.Tensor:
    """Eq. 11 for every vehicle: ``alpha`` ``[K, K]`` on the simplex of each
    row's contact set, by exponentiated gradient (KL in nats)."""
    mask = contacts
    n = mask.sum(-1, keepdim=True).clamp(min=1.0)
    alpha = mask / n
    log_g = torch.log(target.clamp(min=EPS))
    for _ in range(num_steps):
        u = (alpha @ states).clamp(min=EPS)
        grad = (torch.log(u) - log_g + 1.0) @ states.T
        centred = (grad - (grad * mask).sum(-1, keepdim=True) / n) * mask
        scale = step / centred.abs().amax(-1, keepdim=True).clamp(min=1.0)
        logits = torch.where(mask > 0, torch.log(alpha.clamp(EPS, 1.0)) - scale * centred,
                             torch.full_like(alpha, float("-inf")))
        new = torch.softmax(logits, -1) * mask
        alpha = new / new.sum(-1, keepdim=True).clamp(min=EPS)
    return alpha


def kl_bits(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    terms = s * (torch.log2(s.clamp(EPS, 1.0)) - torch.log2(g.clamp(EPS, 1.0)))
    return torch.where(s > EPS, terms, torch.zeros_like(s)).sum(-1)


def entropy_bits(s: torch.Tensor) -> torch.Tensor:
    terms = s * torch.log2(s.clamp(EPS, 1.0))
    return -torch.where(s > EPS, terms, torch.zeros_like(s)).sum(-1)


# ---------------------------------------------------------- federation ----

def run(cfg: dict, seed: int, data: dict, init: dict, mode: str = "f32",
        epochs: int | None = None, inject: dict | None = None, fault: str | None = None) -> dict:
    """One federation of ``epochs`` (default ``cfg["epochs"]``) epochs.

    ``inject`` ``{t: weights [K, ...]}`` puts another run's weights in place
    of the reference's own at the start of epoch ``t`` (0-based): from there
    the reference follows that run step by step. Training diverges between
    two sound runs over tens of epochs (each step amplifies the other's
    rounding), so an evaluated epoch is compared from the same starting
    weights; the first epoch is compared from the common initial weights.

    ``fault`` plants a fault, for the readings that set the comparison's
    limits: ``"half_batch"`` trains on the first half of each batch (the mean
    over the rest), ``"unchanged"`` leaves the weights as local training
    found them.

    ``data``: ``train_x`` ``[N, 28, 28, 1]``, ``train_y`` ``[N]`` (int64),
    ``test_x``, ``test_y`` on the run's device and ``train_y_np`` (numpy,
    for the partition). ``init``: one vehicle's weights (HWIO).
    Returns the contacts ``[T, K, K]`` (numpy), the per-epoch mean KL
    (``kl_trace``), the evaluated epochs with their per-vehicle accuracy,
    KL, entropy and consensus distance, each epoch's mean training loss
    (``loss``), the weights at the start of each evaluated epoch (``snaps``)
    and at the end (``params``), all ``[K, ...]``.
    """
    dev = data["train_x"].device
    k, e_steps, b = cfg["num_vehicles"], cfg["local_steps"], cfg["batch_size"]
    lr, epochs = cfg["lr"], epochs or cfg["epochs"]
    table = torch.as_tensor(partition(data["train_y_np"], k, seed), device=dev)
    target = torch.full((k,), 1.0 / k, device=dev)        # equal shares
    contacts = contact_stream(cfg, seed, epochs)
    params = {n: v.to(dev, torch.float32).expand((k,) + tuple(v.shape)).clone()
              for n, v in init.items()}
    states = torch.zeros(k, k, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    eval_x = data["test_x"][:cfg["eval_samples"]]
    eval_y = data["test_y"][:cfg["eval_samples"]]
    rows = torch.arange(k, device=dev)
    out = {"contacts": contacts, "kl_trace": [], "loss": [], "evals": [], "snaps": {}}
    inject = inject or {}
    with precision(mode):
        for t in range(epochs):
            picks = torch.randint(0, table.shape[1], (k, e_steps, b), generator=g, device=dev)
            idx = table[rows[:, None, None], picks]
            xs, ys = data["train_x"][idx], data["train_y"][idx]
            evaluated = (t + 1) % cfg["eval_every"] == 0 or t == epochs - 1
            if t in inject:
                params = {n: v.to(dev, torch.float32).clone() for n, v in inject[t].items()}
            if evaluated:
                out["snaps"][t] = {n: v.detach().clone() for n, v in params.items()}
            c = torch.as_tensor(contacts[t], device=dev)
            alpha = solve_p1(states, target, c, cfg["p1_steps"], cfg["p1_step_size"])
            w = alpha * c
            w = w / w.sum(-1, keepdim=True).clamp(min=EPS)
            params = {n: (w @ v.reshape(k, -1)).reshape(v.shape) for n, v in params.items()}
            losses = []
            for s in range(e_steps):
                keep = torch.rand((k, b, 50), generator=g, device=dev) >= 0.5
                leaves = {n: v.detach().requires_grad_(True) for n, v in params.items()}
                logp = cnn_forward(leaves, xs[:, s], keep)
                nll = -logp.gather(-1, ys[:, s, :, None]).squeeze(-1)
                loss = (nll[:, : b // 2] if fault == "half_batch" else nll).mean(-1).sum()
                grads = torch.autograd.grad(loss, list(leaves.values()))
                losses.append(float(loss.detach()) / k)
                if fault != "unchanged":
                    params = {n: v - lr * gr for (n, v), gr in zip(params.items(), grads)}
            out["loss"].append(sum(losses) / e_steps)
            states = w @ states
            states = states + (torch.tensor(lr) * torch.tensor(float(e_steps))).item() * torch.eye(k, device=dev)
            tot = states.sum(-1, keepdim=True)
            states = torch.where(tot > EPS, states / tot.clamp(min=EPS), states)
            kl = kl_bits(states, target)
            out["kl_trace"].append(float(kl.mean()))
            if evaluated:
                flat = torch.cat([v.reshape(k, -1) for v in params.values()], 1)
                consensus = ((flat - flat.mean(0, keepdim=True)) ** 2).sum() / k
                out["evals"].append({
                    "epoch": t + 1, "accuracy": accuracy(params, eval_x, eval_y).cpu().numpy(),
                    "kl": kl.cpu().numpy(), "entropy": entropy_bits(states).cpu().numpy(),
                    "consensus": float(consensus)})
    out["params"] = {n: v.detach() for n, v in params.items()}
    return out
