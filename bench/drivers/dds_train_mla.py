"""DFL-DDS training rounds of Moonlight-16B-A3B vehicles (latent attention,
a sigmoid router over 64 experts of which this chip holds 8, shared
experts), back to back, through ``repro_torch.launch.steps.
build_dds_train_step`` under the cell's variant, as ``dds_train`` runs
granite: P1, the gossip mix, one AdamW step per vehicle on fresh tokens, the
state vectors' update.

Set-up builds the train state from the benchmark's weights
(``lib.moonlight``) and drives it through the first three rounds with the
window's own call; the reference (``reference.moonlight``) follows those
rounds. The numbers compared are ``dds_train.compare``'s but ``loss_gap``,
and ``expert_gap``. ``loss_gap`` is printed and not compared: three rounds
of 1e-3 steps from random weights move the loss so little that weights
left unchanged read as sound runs do. ``expert_gap`` takes each routed
expert's first gradient (its slice of the expert stacks, a layer and an
expert, as AdamW got it): the largest gap of its norm over the larger of
the reference's and the median expert's of that leaf, over vehicles. A leaf's norm sums the stack's 6 layers x 8 experts,
where an error that moves each expert its own way averages out. With a timer
(a traced run) the spans read also carry the MoE's ``moe.held_rows``
counter (rows routed to held experts, each forward pass and recompute).
"""
from __future__ import annotations

import sys
import time
from dataclasses import replace

import torch

from ..lib import inputs
from ..lib import moonlight as lib
from ..reference import federation as fed_ref
from ..reference import granite as granite_ref
from ..reference import moonlight as ref
from .dds_train import CHECKED_ROUNDS, _norms, _sync, compare, ring_contact


def _program_config(config: dict):
    """The program's configuration of the cut: the published model at the
    file's depth and expert share (a CPU rehearsal's smaller sizes too)."""
    from repro_torch.configs.moonlight_16b_a3b import CONFIG

    z = lib.sizes(config)
    cfg = replace(CONFIG, num_layers=config["num_hidden_layers"],
                  first_dense_layers=z["L0"], expert_range=(0, z["held"]))
    published = {"d_model": z["d"], "num_heads": z["h"], "num_kv_heads": z["h"],
                 "head_dim": z["nope"] + z["rope"], "qk_rope_dim": z["rope"],
                 "v_head_dim": z["vd"], "kv_lora_rank": z["r"], "d_ff": z["f"],
                 "dense_d_ff": z["F"], "num_experts": z["E"], "shared_experts": z["shared"],
                 "top_k": config["num_experts_per_tok"], "vocab_size": z["V"],
                 "true_vocab_size": z["V"], "true_num_heads": z["h"], "true_num_kv_heads": z["h"],
                 "rope_theta": config["rope_theta"], "norm_eps": config["rms_norm_eps"],
                 "routed_scale": config["routed_scaling_factor"]}
    return replace(cfg, **{k: v for k, v in published.items() if getattr(cfg, k) != v})


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
        self.timer = PhaseTimer(run.device, blocks=True) if run.trace else None
        self.step = steps.build_dds_train_step(
            arch, local_steps=train["local_steps"], lr=self.lr, p1_steps=self.p1_steps,
            remat=train["remat"], timer=self.timer, **overrides)
        dev = run.device
        t0 = time.perf_counter()
        self.leaves = lib.leaves(cfg)
        flat = {}
        for i, (path, shape, _) in enumerate(self.leaves):
            leaf = torch.empty((self.v,) + shape, device=dev)
            lib.leaf(cfg, run.seed, i, dev, out=leaf[0])
            leaf[1:].copy_(leaf[:1].expand_as(leaf[1:]))
            flat[path] = leaf
        zeros = lambda: steps.unflatten({n: torch.zeros_like(x) for n, x in flat.items()})
        self.params = steps.unflatten(flat)
        self.opt = AdamState(count=torch.zeros(self.v, dtype=torch.int32, device=dev),
                             mu=zeros(), nu=zeros())
        self.states = torch.zeros(self.v, self.v, device=dev)
        self.contact = ring_contact(self.v, dev)
        self.target = torch.full((self.v,), 1.0 / self.v, device=dev)
        self.rounds = 0
        _sync(dev)
        print(f"setup: weights {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.losses, self.grads, self.state_rows = [], [], []
        for r in range(CHECKED_ROUNDS):
            t0 = time.perf_counter()
            out = self._round()
            self.losses.append(float(out["loss"]))
            self.state_rows.append(self.states.detach().cpu())
            print(f"setup: round {r + 1} {time.perf_counter() - t0:.3f} s", file=sys.stderr)
            if r == 0:
                mu = steps.flatten(self.opt.mu)
                self.grads = [{n: g / (1 - granite_ref.B1) for n, g in _norms(mu, v).items()}
                              for v in range(self.v)]
                self.experts = [torch.stack([torch.linalg.vector_norm(mu[n][v], dim=(-2, -1))
                                             for n in ref.EXPERT_LEAVES], -1).cpu()
                                / (1 - granite_ref.B1) for v in range(self.v)]
        p = steps.flatten(self.params)
        self.changes = [dict() for _ in range(self.v)]
        for i, (path, _, _) in enumerate(self.leaves):
            init = lib.leaf(cfg, run.seed, i, dev)
            for v in range(self.v):
                self.changes[v][path] = float(torch.linalg.vector_norm(p[path][v] - init))
            del init
        self.span_base = self._spans()

    def _spans(self) -> dict:
        if self.timer is None:
            return {}
        return {**self.timer.totals_ms(), **self.timer.counts()}

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
        """The window's span totals (ms) and counters."""
        return {n: x - self.span_base.get(n, 0.0) for n, x in self._spans().items()}

    def finish(self) -> dict:
        """Free the program's state, follow the first three rounds with the
        reference, return the numbers compared."""
        del self.params, self.opt, self.states, self.step
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
        t0 = time.perf_counter()
        want = follow(self.run.config, self.run.seed, self.v, self.b, self.s, self.lr,
                      self.p1_steps, self.run.device)
        print(f"reference: {time.perf_counter() - t0:.3f} s; the bias changed the top-k of "
              f"{100 * want['bias_share']:.2f} % of (token, layer) pairs", file=sys.stderr)
        numbers = compare_experts({"losses": self.losses, "grads": self.grads,
                                   "changes": self.changes, "states": self.state_rows,
                                   "experts": self.experts}, want)
        print(f"loss_gap {numbers.pop('loss_gap')!r} (not compared)", file=sys.stderr)
        return numbers


def follow(config: dict, seed: int, v: int, b: int, s: int, lr: float, p1_steps: int,
           device, mode: str = "f32", batch_share: float = 1.0,
           fault: str | None = None) -> dict:
    """The reference's three rounds from the benchmark's inputs, as
    ``dds_train.follow``; also ``bias_share``, the share of round 1's
    (token, MoE layer) pairs of vehicle 0 whose top-k the bias changed."""
    leaves = lib.leaves(config)
    state = {"params": [dict() for _ in range(v)], "mu": [dict() for _ in range(v)],
             "nu": [dict() for _ in range(v)], "count": 0,
             "states": torch.zeros(v, v, device=device)}
    for i, (path, _, _) in enumerate(leaves):
        init = lib.leaf(config, seed, i, device)
        for u in range(v):
            state["params"][u][path] = init.clone()
            state["mu"][u][path] = torch.zeros_like(init)
            state["nu"][u][path] = torch.zeros_like(init)
    contact = ring_contact(v, device)
    target = torch.full((v,), 1.0 / v, device=device)
    losses, grads, experts, states, share = [], None, None, [], None
    for r in range(CHECKED_ROUNDS):
        toks = inputs.granite_tokens(config, seed, r, v, b, s, device)
        if r == 0:
            with fed_ref.precision("f32"):
                share = ref.bias_share(state["params"][0], toks[0], config)
        out, g, e = ref.dds_round(state, toks, contact, target, config, lr, p1_steps, mode,
                                  batch_share, fault)
        losses.append(sum(out) / v)
        grads, experts = (g, e) if r == 0 else (grads, experts)
        states.append(state["states"].cpu())
    changes = [dict() for _ in range(v)]
    for i, (path, _, _) in enumerate(leaves):
        init = lib.leaf(config, seed, i, device)
        for u in range(v):
            changes[u][path] = float(torch.linalg.vector_norm(state["params"][u][path] - init))
    return {"losses": losses, "grads": grads, "changes": changes, "states": states,
            "experts": experts, "bias_share": share}


def compare_experts(prog: dict, want: dict) -> dict:
    """``dds_train.compare``'s numbers and ``expert_gap`` (module docstring)."""
    gap = 0.0
    for got, ref_norms in zip(prog["experts"], want["experts"]):
        floor = ref_norms.flatten(0, 1).median(0).values             # per leaf
        gap = max(gap, float(((got - ref_norms).abs() / torch.maximum(ref_norms, floor)).max()))
    return dict(compare(prog, want), expert_gap=gap)
