"""Arithmetic the per-layer metric readers share. ``obs`` is what a traced
run observed: ``spans_ms`` (the program's phase timer, summed over the
window), ``host_ms`` (the harness's host spans, one entry per call),
``epochs`` / ``rounds`` / ``units`` / ``calls`` of the window and
``span_counts``, the same over the calls the spans cover, ``window_s``,
and ``trace`` (``lib.trace.Tracer.summary``: the profiled calls)."""
from __future__ import annotations

from ..costs import peaks


def span_per(obs, span: str, per: str):
    """Device ms of a phase span per epoch or per round of the window."""
    count = obs.span_counts[per]
    if span not in obs.spans_ms or not count:
        return None
    return obs.spans_ms[span] / count


def host_mean(obs, key: str):
    values = obs.host_ms.get(key)
    return sum(values) / len(values) if values else None


def host_per_epoch(obs, key: str):
    values = obs.host_ms.get(key)
    return sum(values) / obs.epochs if values and obs.epochs else None


def idle_pct(obs):
    t = obs.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(obs, flops_per_unit: float, precision: str):
    """The model's operations in the profiled calls over their time and the
    peak of ``precision``."""
    t = obs.trace
    if not t or t["window_s"] <= 0 or not t["units"]:
        return None
    return 100.0 * t["units"] * flops_per_unit / (t["window_s"] * peaks.FLOPS[precision])
