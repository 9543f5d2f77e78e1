"""The train step's AdamW (``launch.steps.adamw_step_``): on the CPU the
per-leaf loop (``steps.adamw_per_leaf_``: ``optim.adamw``'s update and
``apply_updates`` on one-leaf dictionaries), held against ``optim.adamw``'s
whole-tree update bit for bit (always run); on the card the hand-written
kernel (``kernels/adamw``), held against that loop bit for bit on p, mu and
nu over three steps (marker ``cuda``; skipped where there is no CUDA
device). Imports neither jax nor the JAX package:

    python -m pytest -q -m cuda tests/test_torch_adamw.py

Cases: weight decay 0 and 0.1; the counter at 0 and 7; leaves of odd length;
row v = 1 of ``[2, n]`` stacks with n odd (a base off 16 bytes; the gradient a
fresh tensor, so its base differs from the row's mod 16, or itself a row, so
they agree); more than 64 leaves (the table splits); a zero gradient; a
gradient with inf and nan.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.adamw import kernel
from repro_torch.launch import steps
from repro_torch.optim import AdamState, adamw, apply_updates, sgd

LR, STEPS = 1e-3, 3
# leaf lengths of the "odd" case: ragged heads and tails, a vector body
ODD = (1, 3, 5, 7, 64, 1001, 4099)


def _case(kind: str, device) -> list:
    """The leaves of one case as a list of (p, g-per-step, mu, nu), drawn
    from a fixed seed: the same values and the same layout on every call."""
    r = np.random.default_rng(sum(map(ord, kind)))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)

    def leaf(shape, g_row=None):
        n = int(np.prod(shape))
        p, mu = t(r.normal(size=shape)), t(1e-3 * r.normal(size=shape))
        nu = t(r.uniform(0.0, 1e-6, size=shape)) + 2 * mu * mu
        grads = [t(r.normal(size=shape) * 10.0 ** r.integers(-4, 1)) for _ in range(STEPS)]
        if g_row is not None:       # p, mu, nu (and, if asked, g) as row 1 of [2, n] stacks
            stacks = [torch.zeros((2, n), device=device) for _ in range(3)]
            for s, x in zip(stacks, (p, mu, nu)):
                s[1].copy_(x.reshape(-1))
            p, mu, nu = (s[1] for s in stacks)
            if g_row:
                rows = []
                for g in grads:
                    s = torch.zeros((2, n), device=device)
                    s[1].copy_(g.reshape(-1))
                    rows.append(s[1])
                grads = rows
            else:
                grads = [g.reshape(-1) for g in grads]
        return p, grads, mu, nu

    if kind == "odd":
        return ([leaf((n,)) for n in ODD] + [leaf((3, 5)), leaf((2, 7, 9))]
                + [leaf((n,), g_row=False) for n in (5, 1001)]
                + [leaf((n,), g_row=True) for n in (7, 4099)])
    if kind == "many":
        return [leaf((int(n),)) for n in r.integers(1, 300, size=70)]
    assert kind == "special"
    leaves = [leaf((257,)), leaf((1024,)), leaf((33,))]
    for g in leaves[0][1]:
        g.zero_()
    for g in leaves[1][1]:
        g[::97] = float("inf")
        g[1::97] = -float("inf")
        g[2::89] = float("nan")
    return leaves


def _bits(x):
    return x.contiguous().view(torch.int32)


def _named(xs) -> dict:
    return {str(i): x for i, x in enumerate(xs)}


def _run(kind, device, count0, wd, route: str):
    """STEPS steps of one case through ``steps.adamw_step_`` (``route``
    "step": the kernel on the card, the per-leaf loop on the CPU), the
    per-leaf loop ("loop") or ``optim.adamw``'s whole-tree update and
    ``apply_updates`` ("tree"). Returns the leaves' final (p, mu, nu)."""
    leaves = _case(kind, device)
    count = torch.tensor(count0, dtype=torch.int32, device=device)
    opt = adamw(LR, weight_decay=wd)
    p, mu, nu = ([x[i] for x in leaves] for i in (0, 2, 3))
    for s in range(STEPS):
        g = _named([x[1][s] for x in leaves])
        if route == "tree":
            updates, new = opt.update(g, AdamState(count, _named(mu), _named(nu)), _named(p))
            p = list(apply_updates(_named(p), updates).values())
            mu, nu = list(new.mu.values()), list(new.nu.values())
        else:
            run = steps.adamw_step_ if route == "step" else steps.adamw_per_leaf_
            run(opt, _named(p), _named(mu), _named(nu), g, count)
            assert not g                          # every gradient used and dropped
        count += 1
    return list(zip(p, mu, nu))


def _assert_same_bits(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(("p", "mu", "nu"), a, b):
            assert torch.equal(_bits(x), _bits(y)), f"leaf {i}: {name} differs"


CASES = [(kind, count0, wd) for kind in ("odd", "many", "special")
         for count0 in (0, 7) for wd in (0.0, 0.1)]


@pytest.mark.parametrize("kind,count0,wd", CASES)
def test_cpu_step_is_optim_adamw_bit_for_bit(kind, count0, wd):
    """On the CPU the train step's AdamW updates leaf by leaf, in place, and
    gives the bits of ``optim.adamw``'s whole-tree update."""
    want = _run(kind, "cpu", count0, wd, route="tree")
    _assert_same_bits(_run(kind, "cpu", count0, wd, route="step"), want)
    if kind == "special":     # a zero gradient moves p by its decay only; nan is carried
        assert torch.isfinite(want[0][0]).all() and torch.isnan(want[1][0]).any()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_steps_launch_nothing(device):
    before = dict(kernel.launch_counts)
    _run("odd", device, 0, 0.0, route="step")
    assert kernel.launch_counts == before


def test_adamw_carries_the_settings_the_kernel_reads():
    schedule = lambda count: 1e-3 * count
    assert adamw(2e-3, weight_decay=0.1).hyper == dict(lr=2e-3, b1=0.9, b2=0.95, eps=1e-8,
                                                       weight_decay=0.1)
    assert adamw(schedule).hyper["lr"] is schedule
    assert sgd(0.1).hyper is None


def _one(device="cpu", dtype=torch.float32, n=6):
    return [torch.zeros(n, dtype=dtype, device=device) for _ in range(4)]


class _Sub(torch.Tensor):
    pass


@pytest.mark.parametrize("fault,error", [
    ("mixed devices", ValueError), ("float64", TypeError), ("bfloat16", TypeError),
    ("non-contiguous row", ValueError), ("shape", ValueError), ("lengths", ValueError),
    ("meta", ValueError), ("a tensor subclass", TypeError)])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault, error):
    p, g, mu, nu = _one()
    lists = [[p], [g], [mu], [nu]]
    if fault == "mixed devices":
        lists[1] = [torch.zeros(6, device="meta")]
    elif fault in ("float64", "bfloat16"):
        lists[2] = [torch.zeros(6, dtype=getattr(torch, fault))]
    elif fault == "non-contiguous row":
        lists[0] = [torch.zeros(6, 4)[:, 1]]
    elif fault == "shape":
        lists[3] = [torch.zeros(2, 3)]
    elif fault == "lengths":
        lists[1] = [g, g]
    elif fault == "meta":
        lists = [[x] for x in _one("meta")]
    elif fault == "a tensor subclass":      # a DTensor goes as its to_local()
        lists[0] = [p.as_subclass(_Sub)]
    c = torch.ones(())
    with pytest.raises(error):
        kernel.adamw_(*lists, c, c, **adamw(LR).hyper)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    p, g, mu, nu = _one()
    c = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        kernel.adamw_([p], [g], [mu], [nu], c, c, lr=LR, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.0)


# ---------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on a GPU machine: "
                    "python -m pytest -q -m cuda tests/test_torch_adamw.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,count0,wd", CASES)
def test_kernel_is_the_per_leaf_loop_bit_for_bit(card, kind, count0, wd):
    want = _run(kind, card, count0, wd, route="loop")
    kernel.reset_launch_counts()
    got = _run(kind, card, count0, wd, route="step")
    torch.cuda.synchronize()
    leaves = len(_case(kind, "cpu"))
    assert kernel.launch_counts["adamw"] == STEPS * math.ceil(leaves / kernel.max_leaves())
    _assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fault,error", [
    ("a schedule", ValueError), ("bfloat16", TypeError), ("non-contiguous row", ValueError)])
def test_the_step_on_the_card_raises_where_the_kernel_does_not_take_it(card, fault, error):
    """Nothing on the card falls back to the per-leaf loop."""
    p, g, mu, nu = _one(card, n=64)
    opt = adamw(LR)
    if fault == "a schedule":
        opt = adamw(lambda count: LR * torch.ones_like(count, dtype=torch.float32))
    elif fault == "bfloat16":
        g = g.to(torch.bfloat16)
    else:
        p = torch.zeros(64, 2, device=card)[:, 0]
    kernel.reset_launch_counts()
    with pytest.raises(error):
        steps.adamw_step_(opt, {"w": p}, {"w": mu}, {"w": nu}, {"w": g},
                          torch.zeros((), dtype=torch.int32, device=card))
    assert kernel.launch_counts["adamw"] == 0


@pytest.mark.cuda
def test_the_launcher_refuses_a_written_tensor_that_overlaps_another(card):
    p, g, mu, nu = _one(card, n=64)
    c = torch.ones((), device=card)
    hyper = adamw(LR).hyper
    with pytest.raises(ValueError, match="overlaps"):
        kernel.adamw_([p], [g], [p], [nu], c, c, **hyper)
    with pytest.raises(ValueError, match="overlaps"):      # a gradient inside mu
        kernel.adamw_([p[:32]], [mu[8:40]], [mu[:32]], [nu[:32]], c, c, **hyper)
    shared = g[:32]                                         # two gradients may share memory
    kernel.adamw_([p[:32], p[32:]], [shared, shared], [mu[:32], mu[32:]],
                  [nu[:32], nu[32:]], c, c, **hyper)
    torch.cuda.synchronize()
    assert torch.equal(p[:32], p[32:])
