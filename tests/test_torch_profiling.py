"""``profiling.PhaseTimer`` on the CPU: its totals, its spans as
``torch.profiler`` ranges (``repro_torch.<name>``, nested as they ran) in a
federation, in a batch of seeds and in a train round, and a timed run that
computes exactly what an untimed one does."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data.synthetic import synthetic_mnist
from repro_torch.fed import engine, simulator
from repro_torch.launch import steps
from repro_torch.profiling import PhaseTimer, phase

V = 2


@pytest.fixture(scope="module")
def dataset():
    return synthetic_mnist(n_train=800, n_test=100)


def _fed_config(**kw):
    # sparse contacts with d_max unpinned: build_context runs the probe
    base = dict(num_vehicles=8, epochs=1, eval_every=1, eval_samples=100, local_steps=1,
                batch_size=8, p1_steps=10, comm_range=250.0, device="cpu")
    return simulator.SimulationConfig(**dict(base, **kw))


def _ranges(prof) -> list[tuple[str, float, float]]:
    """``(phase, start, end)`` of every ``repro_torch.*`` range, in order."""
    return sorted((e.name[len("repro_torch."):], e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name.startswith("repro_torch."))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def test_totals_keep_the_phase_keys_and_add_host_time():
    timer = PhaseTimer("cpu")
    for _ in range(2):
        with phase(timer, "outer"):
            with phase(timer, "inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    totals = timer.totals_ms()
    assert set(totals) == {"outer", "inner", "outer.host", "inner.host"}
    # on the CPU the phase's time is the host's
    assert totals["outer"] == totals["outer.host"] and totals["inner"] == totals["inner.host"]
    assert totals["outer"] >= totals["inner"] > 0


def _train_inputs():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params, opt, sm = steps.init_train_state(cfg, V, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.true_vocab_size, (V, 2, 8),
                           generator=torch.Generator().manual_seed(1))
    return cfg, (params, opt, sm, tokens, torch.ones(V, V), torch.full((V,), 1.0 / V))


def _train_round(timer):
    cfg, args = _train_inputs()
    fn = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=10, remat=False, timer=timer).fn
    return fn(*args)


@pytest.mark.parametrize("scan_engine", [True, False])
def test_a_timed_federation_shows_its_phases_on_the_profiler_timeline(dataset, scan_engine):
    timer = PhaseTimer("cpu")
    _, ranges = _profiled(lambda: simulator.run_simulation(
        _fed_config(use_scan_engine=scan_engine), dataset=dataset, timer=timer))
    names = {r[0] for r in ranges}
    round_phases = {"contact_window", "p1_solve", "mix", "local_train"}
    assert round_phases | {"build_context", "d_max_probe"} <= names
    if scan_engine:
        assert "eval" in names
    (build,) = [r for r in ranges if r[0] == "build_context"]
    (probe,) = [r for r in ranges if r[0] == "d_max_probe"]
    assert _inside(probe, build)
    # the epoch's phases run after the set-up, outside it
    assert all(r[1] >= build[2] for r in ranges if r[0] in round_phases)
    assert {f"{n}.host" for n in names} <= set(timer.totals_ms())


def test_a_timed_train_round_splits_local_training():
    timer = PhaseTimer("cpu")
    _, ranges = _profiled(lambda: _train_round(timer))
    (local,) = [r for r in ranges if r[0] == "local_train"]
    for name in ("forward", "backward", "adamw"):
        spans = [r for r in ranges if r[0] == name]
        assert len(spans) == V, name       # one local step per vehicle
        assert all(_inside(r, local) for r in spans), name
    totals = timer.totals_ms()
    assert totals["forward"] + totals["backward"] + totals["adamw"] <= totals["local_train"]


def test_run_seeds_spans_each_seeds_set_up(dataset):
    timer = PhaseTimer("cpu")
    seeds = (0, 1, 2)
    results, ranges = _profiled(lambda: engine.run_seeds(
        _fed_config(), seeds, dataset=dataset, timer=timer))
    assert len(results) == len(seeds)
    names = [r[0] for r in ranges]
    assert names.count("build_context") == len(seeds)
    assert names.count("contact_window") == len(seeds)
    # the stacked rounds carry the timer: one P1 solve for every seed
    assert names.count("p1_solve") == 1


@pytest.mark.parametrize("run", ["federation", "train"])
def test_no_timer_opens_no_range(dataset, run):
    work = ((lambda: simulator.run_simulation(_fed_config(), dataset=dataset))
            if run == "federation" else (lambda: _train_round(None)))
    _, ranges = _profiled(work)
    assert ranges == []


def _fed_outputs(dataset, timer):
    ctx = engine.build_context(_fed_config(epochs=2), dataset=dataset, timer=timer)
    result = engine.run_with_context(ctx)
    return result.kl_trace, ctx.final_state


@pytest.mark.parametrize("run", ["federation", "train"])
def test_a_timed_run_computes_what_an_untimed_one_does(dataset, run):
    if run == "federation":
        (kl_a, state_a), (kl_b, state_b) = (_fed_outputs(dataset, None),
                                            _fed_outputs(dataset, PhaseTimer("cpu")))
        assert kl_a == kl_b
    else:
        state_a, state_b = _train_round(None), _train_round(PhaseTimer("cpu"))
    leaves_a, spec_a = torch.utils._pytree.tree_flatten(state_a)
    leaves_b, spec_b = torch.utils._pytree.tree_flatten(state_b)
    assert spec_a == spec_b and len(leaves_a) > 2
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else np.array_equal(a, b)
