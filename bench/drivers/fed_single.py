"""One DFL-DDS federation at a time, as ``fed.simulator.run_simulation``
runs it: ``engine.build_context`` and ``engine.run_with_context``, H epochs,
back to back with successive federation seeds; the dataset is made once.

A federation's initial weights are the benchmark's (``inputs.cnn_init``),
handed to ``build_context``. The comparison re-runs one federation the
window ran, drawn from the run's seed, through the plain reference, which follows it from its
weights at the start of each evaluated epoch (``lib.federation.compare``).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..lib import federation as fed
from ..lib import inputs


class Driver:
    def __init__(self, run):
        from repro_torch.fed import engine
        from repro_torch.profiling import PhaseTimer

        self.run, self.engine = run, engine
        self.traffic = run.cell["traffic"]
        self.horizon = self.traffic["horizon_epochs"]
        t0 = time.perf_counter()
        self.dataset = inputs.synthetic_mnist(run.device, run.seed, **self.traffic.get("data", {}))
        print(f"setup: dataset {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        self.hooks = fed.Hooks(engine)
        self.timer = PhaseTimer(run.device) if run.trace else None
        self.base = int(run.seed) * 1000
        self.done = []
        # warm-up: one 1-epoch federation, evaluated (its last epoch)
        self._federation(self.base + 999, epochs=1, timer=None)
        self.done.clear()
        self.hooks.reset_window()

    def _federation(self, seed: int, epochs: int, timer):
        engine = self.engine
        cfg = fed.sim_config(engine, self.run.config, seed, epochs, self.run.device)
        ctx = engine.build_context(cfg, dataset=self.dataset,
                                   init_params=inputs.cnn_init(self.run.device, seed), timer=timer)
        result = engine.run_with_context(ctx)
        self.done.append((seed, result, ctx.final_state.params, self.hooks.last_snaps,
                          self.hooks.last_loss))

    def call(self) -> dict:
        self._federation(self.base + len(self.done), self.horizon, self.timer)
        return {"units": self.horizon, "epochs": self.horizon}

    def spans_ms(self) -> dict:
        return self.timer.totals_ms() if self.timer is not None else {}

    def finish(self) -> dict:
        """Free the program's state, re-run one federation through the
        reference, return the numbers compared."""
        self.hooks.remove()
        pick = int(np.random.default_rng(int(self.run.seed) % (1 << 63)).integers(len(self.done)))
        seed, result, params, snaps, loss = self.done[pick]
        prog = fed.program_outputs(result, params, self.hooks.contacts[seed], snaps, loss)
        self.done.clear()
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
        return fed.reference_numbers(prog, self.run.config, self.horizon, seed,
                                     fed.reference_data(self.dataset, self.run.device),
                                     inputs.cnn_init(self.run.device, seed))
