"""Port vs reference, ``kernels/grouped_mm`` and the ragged MoE built on it.

The plain version ``ref.grouped_mm_ref`` against ``jax.lax.ragged_dot``, with
empty groups and rows past the last group (f32 atol 1e-5; bf16 atol 5e-2,
rtol 3e-2, the reference's kernel-test tolerances: one bf16 rounding of the
output apart); both gradients, through the custom op's registered backward
(the transposed product and ``grouped_mm_wgrad``, the one backward of the CPU
and the card), against ``jax.grad`` of ``ragged_dot`` in f32 and bf16; the port's
``moe_ragged`` against the reference's at the reduced granite-moe-1b-a400m,
output and every parameter's gradient (1e-5 of the scale, f32); the custom
ops through ``torch.library.opcheck``; ``moe_ragged`` on meta tensors (no
group size read on the host); the flop formulas (2·M·K·N per product). Inputs
come from seeded numpy. The kernel itself is held against the plain version
on the card in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.kernels.grouped_mm import kernel, ops
from repro_torch.kernels.grouped_mm import grouped_mm_ref, grouped_mm_wgrad_ref
from repro_torch.launch import dryrun
from repro_torch.models import moe

ATOL = 1e-5
BF16 = dict(atol=5e-2, rtol=3e-2)
# group sizes: empty groups first, inside and last; one run that leaves rows
# past the last group (ragged_dot gives them 0)
SIZES = [[3, 0, 5, 0, 2], [0, 0, 7, 1, 0], [4, 4, 4], [2, 0, 3]]
M, K, N = 12, 24, 20


def _case(sizes, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(M, K)) / np.sqrt(K)).astype(np.float32)
    w = r.normal(size=(len(sizes), K, N)).astype(np.float32)
    ct = r.normal(size=(M, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    offsets = np.concatenate([[0], np.cumsum(gs)]).astype(np.int32)
    return x, w, ct, gs, offsets


def _t(x, **kw):
    return torch.tensor(np.asarray(x), **kw)      # f32 values, int32 offsets


def _close(got, want, tol=ATOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, f"max |diff| {err:.3e} > {tol:g} x {scale:.3e}"


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("trans_w", [False, True])
def test_plain_version_matches_ragged_dot(sizes, trans_w):
    x, w, _, gs, offsets = _case(sizes, len(sizes) + sum(sizes))
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    stored = np.ascontiguousarray(w.transpose(0, 2, 1)) if trans_w else w
    got = grouped_mm_ref(_t(x), _t(stored), _t(offsets), trans_w)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    if sum(sizes) < M:
        assert not got[sum(sizes):].any()


@pytest.mark.parametrize("sizes", SIZES[:2], ids=str)
def test_plain_version_matches_ragged_dot_in_bf16(sizes):
    x, w, _, gs, offsets = _case(sizes, 7)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jax.lax.ragged_dot(xb, wb, jnp.asarray(gs))
    got = grouped_mm_ref(_t(x).bfloat16(), _t(w).bfloat16(), _t(offsets))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16)


def _jax_grads(x, w, ct, gs):
    def loss(x, w):
        return jnp.sum(jax.lax.ragged_dot(x, w, gs) * ct)
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("sizes", SIZES, ids=str)
@pytest.mark.parametrize("path", ["custom_op", "custom_op_trans"])
def test_gradients_match_jax_grad_of_ragged_dot(sizes, path):
    """Through the custom op's registered backward (the product again with
    the transpose flag flipped, and the weight gradient), with w stored as
    is or transposed."""
    x, w, ct, gs, offsets = _case(sizes, 11 + len(sizes))
    want_dx, want_dw = _jax_grads(x, w, ct, gs)
    trans = path == "custom_op_trans"
    xt = _t(x, requires_grad=True)
    wt = _t(np.ascontiguousarray(w.transpose(0, 2, 1)) if trans else w, requires_grad=True)
    (ops.grouped_mm(xt, wt, _t(offsets), trans) * _t(ct)).sum().backward()
    _close(xt.grad.numpy(), want_dx)
    _close((wt.grad.transpose(1, 2) if trans else wt.grad).numpy(), want_dw)
    for e, size in enumerate(sizes):
        if size == 0:
            assert not wt.grad[e].any()


@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_gradients_match_jax_grad_of_ragged_dot_in_bf16(sizes):
    """The registered backward on bf16 inputs (``opt_ragged``'s dtype)
    against ``jax.grad`` of ``ragged_dot`` in bf16."""
    x, w, ct, gs, offsets = _case(sizes, 17 + len(sizes))
    xb, wb, cb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, ct))
    want_dx, want_dw = jax.grad(lambda x, w: jnp.sum(jax.lax.ragged_dot(x, w, jnp.asarray(gs))
                                                     * cb), argnums=(0, 1))(xb, wb)
    xt = _t(x).bfloat16().requires_grad_()
    wt = _t(w).bfloat16().requires_grad_()
    (ops.grouped_mm(xt, wt, _t(offsets)) * _t(ct).bfloat16()).sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(want_dx, np.float32), **BF16)
    np.testing.assert_allclose(wt.grad.float().numpy(), np.asarray(want_dw, np.float32), **BF16)


def test_wgrad_plain_version_per_group():
    x, _, ct, gs, offsets = _case(SIZES[0], 3)
    got = grouped_mm_wgrad_ref(_t(x), _t(ct), _t(offsets))
    assert got.shape == (len(gs), K, N)
    for e in range(len(gs)):
        rows = slice(offsets[e], offsets[e + 1])
        _close(got[e].numpy(), x[rows].T @ ct[rows])


@pytest.mark.parametrize("trans_w", [False, True])
def test_opcheck_grouped_mm(trans_w):
    x, w, _, _, offsets = _case(SIZES[0], 1)
    w = np.ascontiguousarray(w.transpose(0, 2, 1)) if trans_w else w
    for grad in (False, True):
        args = (_t(x, requires_grad=grad), _t(w, requires_grad=grad), _t(offsets), trans_w)
        result = torch.library.opcheck(torch.ops.repro_torch.grouped_mm.default, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_opcheck_grouped_mm_wgrad():
    x, _, dy, _, offsets = _case(SIZES[1], 2)
    result = torch.library.opcheck(torch.ops.repro_torch.grouped_mm_wgrad.default,
                                   (_t(x), _t(dy), _t(offsets)))
    assert set(result.values()) == {"SUCCESS"}, result


def test_flop_formulas_count_two_mkn_per_product():
    x, w, _, _, offsets = _case(SIZES[0], 4)
    xt, wt = _t(x, requires_grad=True), _t(w, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        ops.grouped_mm_op(xt, wt, _t(offsets))
    assert counter.get_total_flops() == 2 * M * K * N
    with FlopCounterMode(display=False) as counter:
        ops.grouped_mm_op(xt, wt, _t(offsets)).sum().backward()
    # forward, dx (the transposed product) and dw (the weight gradient)
    assert counter.get_total_flops() == 3 * 2 * M * K * N
    with FlopCounterMode(display=False) as counter:
        ops.grouped_mm_wgrad_op(xt.detach(), _t(np.ones((M, N), np.float32)), _t(offsets))
    assert counter.get_total_flops() == 2 * M * K * N
    # the dry run's counter, on meta tensors
    meta = [t.to("meta") for t in (xt.detach(), wt.detach(), _t(offsets))]
    with dryrun.DeviceCounter() as counter:
        ops.grouped_mm(*meta)
    assert counter.flops == 2 * M * K * N
    assert counter.traffic_bytes == 4 * (M * K + len(SIZES[0]) * K * N + M * N) + 4 * 6


def test_cpu_path_takes_the_plain_version_and_the_kernel_refuses_cpu():
    """The MoE's entry point is the custom op on every device; on the CPU its
    body is the plain version, bit for bit."""
    assert ops.grouped_mm is ops.grouped_mm_op
    x, w, _, _, offsets = _case(SIZES[0], 8)
    kernel.reset_launch_counts()
    torch.testing.assert_close(ops.grouped_mm(_t(x), _t(w), _t(offsets)),
                               grouped_mm_ref(_t(x), _t(w), _t(offsets)), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_mm(_t(x), _t(w), _t(offsets))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.grouped_mm_wgrad(_t(x), _t(x), _t(offsets))
    assert kernel.launch_counts == {"grouped_mm": 0, "grouped_mm_wgrad": 0}


# ---------------------------------------------------------------- the MoE ----

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def granite():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    r = np.random.default_rng(0)
    x = (0.5 * r.normal(size=(40, cfg.d_model))).astype(np.float32)
    ct = r.normal(size=(40, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, x, ct


def test_moe_ragged_output_and_gradients_match_reference(granite):
    jcfg, cfg, jp, x, ct = granite

    def loss(p, x):
        out, aux = jmoe.moe_ragged(p, x, jcfg)
        return jnp.sum(out * ct) + aux, out

    (_, want), (want_dp, want_dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tp = {n: _t(v, requires_grad=True) for n, v in jp.items()}
    tx = _t(x, requires_grad=True)
    out, aux = moe.moe_ragged(tp, tx, cfg)
    ((out * _t(ct)).sum() + aux).backward()
    _close(out.detach().numpy(), want)
    _close(tx.grad.numpy(), want_dx)
    for name, g in want_dp.items():
        _close(tp[name].grad.numpy(), g)


def test_moe_ragged_offsets_are_the_group_sizes(granite, monkeypatch):
    """The offsets handed to the grouped products are the cumulative
    per-expert counts of the assignments (a bincount, taken on the device)."""
    _, cfg, jp, x, _ = granite
    seen = []
    real = ops.grouped_mm
    monkeypatch.setattr(ops, "grouped_mm", lambda a, w, o, *r: seen.append(o) or real(a, w, o, *r))
    tp = {n: _t(v) for n, v in jp.items()}
    moe.moe_ragged(tp, _t(x), cfg)
    _, idx, _ = moe.router_topk(_t(x) @ tp["router"], cfg.top_k)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.num_experts)
    assert len(seen) == 3
    for offsets in seen:
        assert offsets.dtype == torch.int32
        assert offsets.tolist() == [0] + np.cumsum(counts).tolist()


def test_moe_ragged_runs_on_meta_tensors(granite):
    _, cfg, jp, x, _ = granite
    tp = {n: torch.empty(v.shape, device="meta", requires_grad=True) for n, v in jp.items()}
    tx = torch.empty(x.shape, device="meta", requires_grad=True)
    out, aux = moe.moe_ragged(tp, tx, cfg)
    assert out.shape == x.shape and out.device.type == "meta" and aux.shape == ()
    (out.sum() + aux).backward()
    assert all(tp[n].grad.shape == tp[n].shape for n in tp)
    with dryrun.DeviceCounter() as counter:
        moe.moe_ragged(tp, tx, cfg)
    n_k = x.shape[0] * cfg.top_k
    expert_flops = 3 * 2 * n_k * cfg.d_model * cfg.d_ff
    router_flops = 2 * x.shape[0] * cfg.d_model * cfg.num_experts
    assert counter.flops == expert_flops + router_flops
