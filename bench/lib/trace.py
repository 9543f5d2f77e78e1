"""The device trace of a traced run, reduced to what the metrics read.

``Tracer`` wraps ``torch.profiler`` around the calls a traced run records.
``summary()`` walks the raw device events once and gives:

* ``busy_s``: the union of the device's activity intervals (kernels, copies,
  sets), ``window_s``: the host time the recorded calls took;
* ``kernels``: ``{name: [launches, seconds]}`` per device op;
* ``idle_gaps``: the longest stretches with nothing on the device, each named
  by the harness's host span running at its start (``bench.<span>``) or, where
  none is, by the device op that ended the gap.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.host_s = 0.0
        self.units = 0.0
        self.closed = False

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def record(self, fn):
        """Run ``fn`` as one recorded call; the caller adds its units."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s += time.perf_counter() - t0
        return out

    def __exit__(self, *exc):
        if self.prof is not None and not self.closed:
            self.prof.__exit__(*exc)
            self.closed = True
        return False

    def summary(self, top: int = 10) -> dict | None:
        if self.prof is None:
            return None
        device, spans = [], []
        for ev in self.prof.profiler.kineto_results.events():
            name = ev.name()
            start, dur = ev.start_ns(), ev.duration_ns()
            if name.startswith("bench."):
                if not str(ev.device_type()).endswith("CUDA"):
                    spans.append((start, start + dur, name[len("bench."):]))
            elif str(ev.device_type()).endswith("CUDA") and not ev.is_user_annotation():
                device.append((start, start + dur, name))
        if not device:
            return {"busy_s": 0.0, "window_s": self.host_s, "kernels": {}, "idle_gaps": [],
                    "units": self.units}
        device.sort()
        spans.sort()
        kernels = defaultdict(lambda: [0, 0.0])
        busy, gaps = 0, []
        cur_s, cur_e = device[0][0], device[0][1]
        for s, e, name in device:
            kernels[name][0] += 1
            kernels[name][1] += (e - s) / 1e9
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, name))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        gaps.sort(reverse=True)
        named = []
        for length, at, after in gaps[:top]:
            label = next((n for s, e, n in spans if s <= at < e), None)
            named.append([label or f"before {after[:80]}", length / 1e9])
        return {"busy_s": busy / 1e9, "window_s": self.host_s, "kernels": dict(kernels),
                "idle_gaps": named, "units": self.units}


def span(name: str):
    """A host span the trace can name idle gaps by."""
    return torch.profiler.record_function(f"bench.{name}")
