"""S federations batched as one seed-stacked run, as the campaign path
(``launch/sweep.run_sweep``) runs them: ``engine.run_seeds`` on S seeds, H
epochs, whole calls back to back with the seeds advancing each call; the
dataset is made once.

``run_seeds`` takes no initial weights: each federation draws its own from
its seed, and the reference draws them alike (``reference.federation
.cnn_init_drawn``). The comparison re-runs one federation of one call, both
drawn from the run's seed, through the plain reference.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..lib import federation as fed
from ..lib import inputs
from ..reference import federation as ref


class Driver:
    def __init__(self, run):
        from repro_torch.fed import engine

        self.run, self.engine = run, engine
        self.traffic = run.cell["traffic"]
        self.horizon = self.traffic["horizon_epochs"]
        self.seeds = self.traffic["seeds_per_call"]
        t0 = time.perf_counter()
        self.dataset = inputs.synthetic_mnist(run.device, run.seed, **self.traffic.get("data", {}))
        print(f"setup: dataset {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.hooks = fed.Hooks(engine)
        self.timer = None                       # run_seeds takes no timer
        self.base = int(run.seed) * 1000
        self.done = []
        # warm-up: one 1-epoch call on S seeds, evaluated (its last epoch)
        self._call(self.base + 900, epochs=1)
        self.done.clear()
        self.hooks.reset_window()

    def _call(self, first: int, epochs: int):
        engine = self.engine
        seeds = list(range(first, first + self.seeds))
        cfg = fed.sim_config(engine, self.run.config, seeds[0], epochs, self.run.device)
        results = engine.run_seeds(cfg, seeds, dataset=self.dataset)
        self.done.append((seeds, results, self.hooks.last_state.params, self.hooks.last_snaps,
                          self.hooks.last_loss))

    def call(self) -> dict:
        self._call(self.base + self.seeds * len(self.done), self.horizon)
        return {"units": self.horizon * self.seeds, "epochs": self.horizon}

    def spans_ms(self) -> dict:
        return {}

    def finish(self) -> dict:
        self.hooks.remove()
        rng = np.random.default_rng(int(self.run.seed) % (1 << 63))
        call = int(rng.integers(len(self.done)))
        s = int(rng.integers(self.seeds))
        seeds, results, params, snaps, loss = self.done[call]
        seed = seeds[s]
        prog = fed.program_outputs(results[s], {n: v[s] for n, v in params.items()},
                                   self.hooks.contacts[seed],
                                   {t: {n: v[s] for n, v in w.items()} for t, w in snaps.items()},
                                   loss[:, s])
        self.done.clear()
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
        return fed.reference_numbers(prog, self.run.config, self.horizon, seed,
                                     fed.reference_data(self.dataset, self.run.device),
                                     ref.cnn_init_drawn(seed))
