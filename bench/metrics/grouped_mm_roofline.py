"""Sum of the least times of every `grouped_mm` / `grouped_mm_wgrad` launch
in the profiled rounds (bench/costs/grouped_mm, bf16, against the published
peaks) over their summed device time. None where the launches counted are
not the rounds' expected number."""
from bench.costs import grouped_mm


def read(obs):
    t = obs.trace
    if not t:
        return None
    hits = [(n, s) for name, (n, s) in t["kernels"].items() if "grouped_kernel" in name]
    launches, seconds = sum(n for n, _ in hits), sum(s for _, s in hits)
    traffic = obs.cell["traffic"]
    fwd, wgrad = grouped_mm.launches_per_vehicle_step(obs.config)
    tokens = traffic["batch"] * traffic["seq"]
    rounds = t["units"] / (traffic["vehicles"] * tokens)
    if not seconds or launches != round(rounds * traffic["vehicles"] * (fwd + wgrad)):
        return None
    least = launches * grouped_mm.least_seconds_per_launch(obs.config, tokens, 2, "bf16")
    return 100.0 * least / seconds
