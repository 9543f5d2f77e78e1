"""Per-phase timing of a federation round.

``PhaseTimer`` brackets named phases (P1 solve, gossip mix, local training,
state update, eval) with CUDA events on a CUDA device — recorded on the
current stream, so timing adds no synchronisation to the run — or with the
host clock on the CPU. ``totals_ms()`` synchronises once and sums per phase.
A run without a timer pays nothing: ``phase(None, name)`` is a null context.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._spans = defaultdict(list)   # name -> [(start, end)]

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._spans[name].append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._spans[name].append((t0, time.perf_counter()))

    def totals_ms(self) -> dict[str, float]:
        """Milliseconds per phase (device time on CUDA, host time on the
        CPU)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            return {name: sum(s.elapsed_time(e) for s, e in spans)
                    for name, spans in self._spans.items()}
        return {name: sum((e - s) * 1e3 for s, e in spans)
                for name, spans in self._spans.items()}


def phase(timer: PhaseTimer | None, name: str):
    """``timer.phase(name)``, or a null context when no timer is attached."""
    return timer.phase(name) if timer is not None else contextlib.nullcontext()
