"""What the two federation drivers share: the program's configuration from
the cell's files, the harness's spans around the program's layers, and the
comparison of a federation the window ran with the plain reference.

The spans wrap four calls of ``repro_torch.fed.engine`` for the run's
length (restored by ``Hooks.remove``): ``build_context`` and
``ContactStream.window`` are timed on the host, each a ``bench.*`` span of
the trace, and ``probe_d_max`` inside the first; the window ``build_window_fn`` builds hands its final state to the
harness (the seed-stacked ``run_seeds`` keeps it to itself) with its loss of
every epoch, and its round keeps a device copy of the weights at the start of
each evaluated epoch (a few copies of 8.7 MB a federation). The contact
windows the program made are kept (host arrays it made anyway) for the
comparison.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from ..reference import federation as ref
from . import trace


def sim_config(engine, config: dict, seed: int, epochs: int, device):
    """The program's ``SimulationConfig`` for one federation of the cell."""
    return engine.SimulationConfig(
        algorithm=config["algorithm"], dataset="mnist", road_net=config["road_net"],
        distribution=config["distribution"], num_vehicles=config["num_vehicles"],
        epochs=epochs, lr=config["lr"], local_steps=config["local_steps"],
        batch_size=config["batch_size"], comm_range=config["comm_range"],
        epoch_duration=config["epoch_duration"], eval_every=config["eval_every"],
        eval_samples=config["eval_samples"], p1_steps=config["p1_steps"],
        p1_step_size=config["p1_step_size"], seed=int(seed), mobility=config["mobility"],
        device=str(device), **config["program"])


class Hooks:
    def __init__(self, engine):
        self.engine = engine
        self.host_ms = defaultdict(list)
        self.contacts = defaultdict(list)     # federation seed -> windows
        self.last_state = self.last_snaps = self.last_loss = None
        self._saved = (engine.build_context, engine.ContactStream.window,
                       engine.build_window_fn, engine.probe_d_max)
        build, window, build_window, probe = self._saved
        hooks = self

        def build_context(*args, **kwargs):
            t0 = time.perf_counter()
            with trace.span("build_context"):
                out = build(*args, **kwargs)
            hooks.host_ms["build_context"].append((time.perf_counter() - t0) * 1e3)
            return out

        def probe_d_max(*args, **kwargs):
            t0 = time.perf_counter()
            out = probe(*args, **kwargs)
            hooks.host_ms["d_max_probe"].append((time.perf_counter() - t0) * 1e3)
            return out

        def contact_window(stream, num_epochs):
            t0 = time.perf_counter()
            with trace.span("contact_stream"):
                out = window(stream, num_epochs)
            hooks.host_ms["contact_window"].append((time.perf_counter() - t0) * 1e3)
            hooks.contacts[int(stream.cfg.seed)].append(out)
            return out

        def build_window_fn(ctx):
            cfg, real, snaps, count = ctx.cfg, ctx.round_fn, {}, [0]

            def round_fn(state, *args):
                t = count[0]
                count[0] += 1
                if (t + 1) % cfg.eval_every == 0 or t == cfg.epochs - 1:
                    snaps[t] = {n: v.clone() for n, v in state.params.items()}
                return real(state, *args)

            fn = build_window(dataclasses.replace(ctx, round_fn=round_fn))

            def run(*args):
                out = fn(*args)
                hooks.last_state, hooks.last_snaps = out[0], snaps
                hooks.last_loss = out[2]["loss"]
                return out
            return run

        engine.build_context = build_context
        engine.ContactStream.window = contact_window
        engine.build_window_fn = build_window_fn
        engine.probe_d_max = probe_d_max

    def remove(self):
        e = self.engine
        e.build_context, e.ContactStream.window, e.build_window_fn, e.probe_d_max = self._saved

    def reset_window(self):
        """Print what the warm-up's spans took, then forget it."""
        for name, ms in self.host_ms.items():
            print(f"setup: warm-up {name} {sum(ms) / 1e3:.3f} s", file=sys.stderr)
        self.host_ms.clear()
        self.contacts.clear()
        self.last_state = self.last_snaps = self.last_loss = None


def dense_contacts(windows: list) -> np.ndarray:
    """The program's contact windows of one federation (neighbour lists
    ``(idx, mask)`` ``[T, K, D]``) as one dense ``[T, K, K]`` 0/1 array."""
    idx = np.concatenate([np.asarray(w.idx) for w in windows]).astype(np.int64)
    mask = np.concatenate([np.asarray(w.mask) for w in windows])
    t, k, d = idx.shape
    out = np.zeros((t, k, k), np.float32)
    np.add.at(out, (np.arange(t)[:, None, None], np.arange(k)[None, :, None], idx), mask)
    return np.minimum(out, 1.0)


def program_outputs(result, params: dict, windows: list, snaps: dict, loss) -> dict:
    """What the window produced for one federation: its outputs on the host,
    its mean training loss of every epoch and its weights at the start of
    each evaluated epoch (``snaps``)."""
    return {"contacts": dense_contacts(windows),
            "loss": np.asarray(loss.detach().cpu(), np.float64),
            "snaps": snaps,
            "kl_trace": np.asarray(result.kl_trace, np.float64),
            "epochs": list(result.epochs_evaluated),
            "accuracy": [np.asarray(a) for a in result.vehicle_accuracy],
            "kl": [np.asarray(a) for a in result.kl_divergence],
            "entropy": [np.asarray(a) for a in result.entropy],
            "consensus": list(result.consensus_distance),
            "params": {n: v.detach().cpu() for n, v in params.items()}}


def reference_data(dataset, device) -> dict:
    return {"train_x": torch.as_tensor(dataset.train_x, device=device),
            "train_y": torch.as_tensor(dataset.train_y, device=device).long(),
            "test_x": torch.as_tensor(dataset.test_x, device=device),
            "test_y": torch.as_tensor(dataset.test_y, device=device).long(),
            "train_y_np": dataset.train_y}


def compare(prog: dict, want: dict) -> dict:
    """The numbers compared, each the worst over the federation (``want``
    is the reference run that followed ``prog`` from its weights at the start
    of each evaluated epoch):

    * ``contact_mismatch``: entries of the ``[T, K, K]`` contacts that differ;
    * ``state_gap_bits``: the largest gap of the mean KL of every epoch and of
      each vehicle's KL and entropy on the evaluated epochs (bits): P1's
      weights, the mix of the state vectors, their update;
    * ``loss_gap``: the largest relative gap of an epoch's mean training
      loss, over the first epoch (from the common start) and the evaluated
      ones (from the same weights);
    * ``param_gap``: over the leaves of the final weights, the largest
      ``|w - w_ref|`` over the larger of ``|w_ref|`` and the median leaf's
      norm;
    * ``accuracy_gap``: the largest mean over vehicles of the accuracy's gap
      on an evaluated epoch.
    """
    evals = want["evals"]
    if prog["epochs"] != [e["epoch"] for e in evals]:
        return {"evaluated_epochs_differ": float("inf")}
    state = np.abs(prog["kl_trace"] - np.asarray(want["kl_trace"])).max()
    for i, e in enumerate(evals):
        state = max(state, np.abs(prog["kl"][i] - e["kl"]).max(),
                    np.abs(prog["entropy"][i] - e["entropy"]).max())
    epochs = [0] + [e["epoch"] - 1 for e in evals]
    loss = max(abs(prog["loss"][t] - want["loss"][t]) / abs(want["loss"][t]) for t in epochs)

    def gap(got, ref, label):
        norms = {n: float(torch.linalg.vector_norm(r.cpu())) for n, r in ref.items()}
        floor = statistics.median(norms.values())
        gaps = {n: float(torch.linalg.vector_norm(got[n].cpu() - r.cpu())) / max(norms[n], floor)
                for n, r in ref.items()}
        print(f"{label} by leaf: " + ", ".join(f"{n} {g:.3g} (|ref| {norms[n]:.3g})"
                                              for n, g in gaps.items()), file=sys.stderr)
        return max(gaps.values())

    return {
        "contact_mismatch": float((prog["contacts"] != want["contacts"]).sum()),
        "state_gap_bits": float(state),
        "loss_gap": float(loss),
        "param_gap": gap(prog["params"], want["params"], "param_gap"),
        "accuracy_gap": max(float(np.abs(prog["accuracy"][i] - e["accuracy"]).mean())
                            for i, e in enumerate(evals)),
    }


def reference_numbers(prog: dict, config: dict, horizon: int, seed: int, data: dict,
                      init: dict) -> dict:
    cfg = dict(config, epochs=horizon)
    return compare(prog, ref.run(cfg, seed, data, init, inject=prog["snaps"]))
