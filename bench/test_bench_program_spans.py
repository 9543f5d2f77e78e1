"""The per-layer metrics read from the program's own spans (its
``PhaseTimer`` on two clocks): the CPU rehearsal's traced run of each cell
reads every one the manifest lists there."""
import pytest

from bench.lib import harness
from bench.test_bench_rehearsal import rehearse

SPAN_METRICS = {
    "mnist-cnn.k100.single": ["build_context_ms.single", "d_max_probe_ms.single",
                              "contact_window_ms.single", "p1_host_ms.single"],
    "granite-moe-1b-a400m.train.v2-s4096": ["p1_host_ms.train", "forward_ms.train",
                                            "backward_ms.train", "adamw_ms.train",
                                            "adamw_host_ms.train"],
}
SPAN_METRICS["granite-moe-1b-a400m.train.v2-s1024"] = SPAN_METRICS[
    "granite-moe-1b-a400m.train.v2-s4096"]


@pytest.mark.parametrize("cell", list(SPAN_METRICS))
def test_traced_run_reads_the_program_spans(cell):
    listed = {m["name"] for m in harness.metrics_of(harness.manifest(), "per_layer", cell)}
    assert set(SPAN_METRICS[cell]) <= listed
    result = rehearse(cell, traced=True)
    assert result["correct"]
    for name in SPAN_METRICS[cell]:
        value = result["metrics"].get(name, {}).get("value")
        assert value is not None and value > 0, name
    if cell.startswith("granite"):
        # the three parts of local training lie inside it
        parts = sum(result["metrics"][n]["value"]
                    for n in ("forward_ms.train", "backward_ms.train", "adamw_ms.train"))
        assert parts <= result["metrics"]["local_train_ms.train"]["value"]
