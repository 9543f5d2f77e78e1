"""DFL-DDS training rounds of transformer vehicles, back to back, through
``repro_torch.launch.steps.build_dds_train_step`` under the cell's variant
(``launch/variants.apply_variant``): P1, the gossip mix, one AdamW step per
vehicle on fresh tokens, the state vectors' update.

Set-up builds the train state once from the benchmark's weights and drives
it through the first three rounds with the window's own call; those rounds
warm the program up and are what the reference follows. The window goes on
from round 4 with the same objects. Compared (by the worst leaf, over
vehicles): each of the three rounds' loss; the first gradient as AdamW got
it (its first moment after one step over 1 - b1); the change of the weights
after three rounds; the state matrix each round returned, which carries
P1's weights (round r's is ``W_r S_{r-1}`` with the local step, normalised).
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

from ..lib import inputs
from ..reference import granite as ref

CHECKED_ROUNDS = 3


def ring_contact(v: int, device) -> torch.Tensor:
    """Vehicles around a loop road: each meets itself and its two
    neighbours."""
    c = torch.eye(v)
    for i in range(v):
        c[i, (i + 1) % v] = c[i, (i - 1) % v] = 1.0
    return c.to(device)


def _program_config(config: dict):
    from repro_torch.configs.granite_moe_1b_a400m import CONFIG

    got = {"num_hidden_layers": CONFIG.num_layers, "hidden_size": CONFIG.d_model,
           "num_attention_heads": CONFIG.num_heads, "num_key_value_heads": CONFIG.num_kv_heads,
           "head_dim": CONFIG.head_dim, "intermediate_size": CONFIG.d_ff,
           "vocab_size": CONFIG.vocab_size, "num_local_experts": CONFIG.num_experts,
           "num_experts_per_tok": CONFIG.top_k, "rope_theta": CONFIG.rope_theta}
    differ = {k: (v, config[k]) for k, v in got.items() if v != config[k]}
    if differ:
        # a cut-down configuration (the CPU rehearsal) runs the same model
        from dataclasses import replace
        CONFIG = replace(CONFIG, num_layers=config["num_hidden_layers"],
                         d_model=config["hidden_size"], num_heads=config["num_attention_heads"],
                         num_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
                         d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
                         true_vocab_size=config["vocab_size"],
                         true_num_heads=config["num_attention_heads"],
                         true_num_kv_heads=config["num_key_value_heads"],
                         num_experts=config["num_local_experts"],
                         top_k=config["num_experts_per_tok"])
    return CONFIG


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _norms(rows: dict, v: int) -> dict:
    return {n: float(torch.linalg.vector_norm(x[v])) for n, x in rows.items()}


class Driver:
    def __init__(self, run):
        from repro_torch.launch import steps, variants
        from repro_torch.optim import AdamState
        from repro_torch.profiling import PhaseTimer

        self.run = run
        cfg, t = run.config, run.cell["traffic"]
        train = cfg["training"]
        self.v, self.b, self.s = t["vehicles"], t["batch"], t["seq"]
        self.lr, self.p1_steps = train["lr"], train["p1_steps"]
        arch, overrides = variants.apply_variant(train["variant"], _program_config(cfg), "train")
        self.timer = PhaseTimer(run.device) if run.trace else None
        self.step = steps.build_dds_train_step(
            arch, local_steps=train["local_steps"], lr=self.lr, p1_steps=self.p1_steps,
            remat=train["remat"], timer=self.timer, **overrides)
        dev = run.device
        t0 = time.perf_counter()
        self.leaves = inputs.granite_leaves(cfg)
        flat = {}
        for i, (path, shape, _) in enumerate(self.leaves):
            leaf = torch.empty((self.v,) + shape, device=dev)
            inputs.granite_leaf(cfg, run.seed, i, dev, out=leaf[0])
            leaf[1:].copy_(leaf[:1].expand_as(leaf[1:]))
            flat[path] = leaf
        zeros = lambda: steps.unflatten({n: torch.zeros_like(x) for n, x in flat.items()})
        self.params = steps.unflatten(flat)
        self.opt = AdamState(count=torch.zeros(self.v, dtype=torch.int32, device=dev),
                             mu=zeros(), nu=zeros())
        self.states = torch.zeros(self.v, self.v, device=dev)
        self.contact = ring_contact(self.v, dev)
        self.target = torch.full((self.v,), 1.0 / self.v, device=dev)
        self.flatten = steps.flatten
        self.rounds = 0
        _sync(dev)
        print(f"setup: weights {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        # the first three rounds: warm-up, and what the reference follows
        self.losses, self.grads, self.changes, self.state_rows = [], [], [], []
        for r in range(CHECKED_ROUNDS):
            t0 = time.perf_counter()
            out = self._round()
            self.losses.append(float(out["loss"]))
            self.state_rows.append(self.states.detach().cpu())
            print(f"setup: round {r + 1} {time.perf_counter() - t0:.3f} s", file=sys.stderr)
            if r == 0:
                mu = self.flatten(self.opt.mu)
                self.grads = [{n: g / (1 - ref.B1) for n, g in _norms(mu, v).items()}
                              for v in range(self.v)]
        p = self.flatten(self.params)
        self.changes = [dict() for _ in range(self.v)]
        for i, (path, _, _) in enumerate(self.leaves):
            init = inputs.granite_leaf(cfg, run.seed, i, dev)
            for v in range(self.v):
                self.changes[v][path] = float(torch.linalg.vector_norm(p[path][v] - init))
            del init
        # the spans count the window's rounds only
        self.span_base = self.timer.totals_ms() if self.timer is not None else {}

    def _round(self):
        toks = inputs.granite_tokens(self.run.config, self.run.seed, self.rounds, self.v,
                                     self.b, self.s, self.run.device)
        self.params, self.opt, self.states, metrics = self.step.fn(
            self.params, self.opt, self.states, toks, self.contact, self.target)
        self.rounds += 1
        return metrics

    def call(self) -> dict:
        self._round()
        return {"units": self.v * self.b * self.s, "rounds": 1}

    def spans_ms(self) -> dict:
        if self.timer is None:
            return {}
        return {n: ms - self.span_base.get(n, 0.0) for n, ms in self.timer.totals_ms().items()}

    def finish(self) -> dict:
        """Free the program's state, follow the first three rounds with the
        reference, return the numbers compared."""
        del self.params, self.opt, self.states, self.step
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
        want = follow(self.run.config, self.run.seed, self.v, self.b, self.s, self.lr,
                      self.p1_steps, self.run.device)
        return compare({"losses": self.losses, "grads": self.grads, "changes": self.changes,
                        "states": self.state_rows}, want)


def follow(config: dict, seed: int, v: int, b: int, s: int, lr: float, p1_steps: int,
           device, mode: str = "f32", batch_share: float = 1.0) -> dict:
    """The reference's three rounds from the benchmark's inputs: the mean
    loss of each round, the first gradient's norms, the change's norms, the
    state matrix after each round."""
    leaves = inputs.granite_leaves(config)
    state = {"params": [dict() for _ in range(v)], "mu": [dict() for _ in range(v)],
             "nu": [dict() for _ in range(v)], "count": 0,
             "states": torch.zeros(v, v, device=device)}
    for i, (path, _, _) in enumerate(leaves):
        init = inputs.granite_leaf(config, seed, i, device)
        for u in range(v):
            state["params"][u][path] = init.clone()
            state["mu"][u][path] = torch.zeros_like(init)
            state["nu"][u][path] = torch.zeros_like(init)
    contact = ring_contact(v, device)
    target = torch.full((v,), 1.0 / v, device=device)
    losses, grads, states = [], None, []
    for r in range(CHECKED_ROUNDS):
        toks = inputs.granite_tokens(config, seed, r, v, b, s, device)
        out, g = ref.dds_round(state, toks, contact, target, config, lr, p1_steps, mode,
                               batch_share)
        losses.append(sum(out) / v)
        grads = g if r == 0 else grads
        states.append(state["states"].cpu())
    changes = [dict() for _ in range(v)]
    for i, (path, _, _) in enumerate(leaves):
        init = inputs.granite_leaf(config, seed, i, device)
        for u in range(v):
            changes[u][path] = float(torch.linalg.vector_norm(state["params"][u][path] - init))
    return {"losses": losses, "grads": grads, "changes": changes, "states": states}


def compare(prog: dict, want: dict) -> dict:
    """``loss_gap``: the largest relative gap of a round's loss.
    ``grad_gap`` / ``change_gap``: over vehicles and leaves, the largest gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf; ``change_gap``
    leaves out leaves whose reference gradient is under a thousandth of the
    median leaf's (they move under AdamW by round-off alone).
    ``state_gap``: the largest gap of an entry of a round's state matrix
    (rows on the simplex, so the gap is a share of the row's sum)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    grad = change = 0.0
    for v, (gw, cw) in enumerate(zip(want["grads"], want["changes"])):
        g_med, c_med = statistics.median(gw.values()), statistics.median(cw.values())
        for n in gw:
            grad = max(grad, abs(prog["grads"][v][n] - gw[n]) / max(gw[n], g_med))
            if gw[n] >= 1e-3 * g_med:
                change = max(change, abs(prog["changes"][v][n] - cw[n]) / max(cw[n], c_med))
    state = max(float((a - b).abs().max()) for a, b in zip(prog["states"], want["states"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change, "state_gap": state}
