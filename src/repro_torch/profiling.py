"""Per-phase timing of a federation or a train round.

``PhaseTimer`` brackets named phases (set-up, the contact stream, P1 solve,
gossip mix, local training and its forward, backward and AdamW, state
update, eval) on two clocks: the host's (``time.perf_counter_ns``) and, on a
CUDA device, CUDA events recorded on the current stream, so timing adds no
synchronisation to the run. Each phase is also a
``torch.profiler.record_function`` range ``repro_torch.<name>``: under a
profiler the phases, nested as they ran, share the trace's clock with the
device's activity. ``totals_ms()`` synchronises once and sums per phase.
A run without a timer pays nothing: ``phase(None, name)`` is a null context.
``count(name, value)`` adds to a counter on the value's device (no
synchronisation); ``counts()`` reads them, beside ``totals_ms()``.
``blocks`` asks the train step to hand the timer to the model too, which
then opens spans inside each block (``models/transformer``).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device, blocks: bool = False):
        self.device = torch.device(device)
        self.blocks = blocks
        self.cuda = self.device.type == "cuda"
        self._events = defaultdict(list)   # name -> [(start, end)] CUDA events
        self._host_ns = defaultdict(int)   # name -> host ns inside the phase
        self._counts = {}                  # name -> running sum (a tensor where added so)

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(f"repro_torch.{name}"):
            t0 = time.perf_counter_ns()
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            try:
                yield
            finally:
                if self.cuda:
                    end.record()
                    self._events[name].append((start, end))
                self._host_ns[name] += time.perf_counter_ns() - t0

    def count(self, name: str, value) -> None:
        """Adds ``value`` (a number, or a 0-d tensor summed where it lives)
        to counter ``name``."""
        self._counts[name] = self._counts.get(name, 0) + value

    def counts(self) -> dict[str, float]:
        """Every counter's sum (one read of each)."""
        return {name: float(v) for name, v in self._counts.items()}

    def totals_ms(self) -> dict[str, float]:
        """Milliseconds per phase: ``<name>`` device time on CUDA (host time
        on the CPU), ``<name>.host`` the host's time inside the phase."""
        host = {name: ns / 1e6 for name, ns in self._host_ns.items()}
        if self.cuda:
            torch.cuda.synchronize(self.device)
            totals = {name: sum(s.elapsed_time(e) for s, e in spans)
                      for name, spans in self._events.items()}
        else:
            totals = dict(host)
        totals.update({f"{name}.host": ms for name, ms in host.items()})
        return totals


def phase(timer: PhaseTimer | None, name: str):
    """``timer.phase(name)``, or a null context when no timer is attached."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext()
