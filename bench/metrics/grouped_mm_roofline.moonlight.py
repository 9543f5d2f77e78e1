"""Least time of every `grouped_mm` / `grouped_mm_wgrad` launch in the
profiled rounds over their summed device time (`grouped_kernel`), bf16
against the published peaks. Each launch is taken at the mean rows a held
expert group had in a layer pass of the window, from the MoE's counter
`moe.held_rows` (every forward pass and its recompute: two a layer and
vehicle step, each feeding six launches), through bench/costs/grouped_mm
at d, f and the held experts. None without the counter, or where the
launches counted are not the rounds' 12 x MoE layers x vehicles."""
from bench.costs import grouped_mm, peaks


def read(obs):
    t, held = obs.trace, obs.spans_ms.get("moe.held_rows")
    if not t or not held or not obs.span_counts["rounds"]:
        return None
    hits = [(n, s) for name, (n, s) in t["kernels"].items() if "grouped_kernel" in name]
    launches, seconds = sum(n for n, _ in hits), sum(s for _, s in hits)
    cfg, traffic = obs.config, obs.cell["traffic"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    rounds = t["units"] / (traffic["vehicles"] * traffic["batch"] * traffic["seq"])
    if not seconds or launches != round(rounds * traffic["vehicles"] * 12 * moe_layers):
        return None
    passes = obs.span_counts["rounds"] * traffic["vehicles"] * moe_layers * 2
    flops, nbytes = grouped_mm.product(held / passes, cfg["hidden_size"],
                                       cfg["moe_intermediate_size"], cfg["n_routed_experts"], 2)
    return 100.0 * launches * peaks.least_seconds(flops, nbytes, "bf16") / seconds
