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
group size read on the host); the flop formulas (2·M·K·N per product). The
kernel's arithmetic and schedule, which only the card runs: its f32 3xTF32
products emulated in torch (short chains at mixtral's K = 4,096, a wgrad
reduction of 2,048 rows) within 1e-5 of the plain version's scale, where one
TF32 product is not; ``kernel.tile_schedule``, the mirror of the device's tile
enumeration, against the rules the kernel keeps. Inputs come from seeded
numpy. The kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
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


# ------------------------------------------------- the kernel's arithmetic ----
# The f32 path of the kernel runs 3xTF32 on the tensor cores: each operand is
# split into big = tf32(a) (rounded to nearest) and small = a - big, which the
# tensor cores read cut to tf32; each BK-slice of the reduction is summed from
# 0 in one chain and added into f32 sums. Emulated here in plain torch against
# the plain version.

def _tf32(x):
    """Round float32 to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x):
    """float32 as the tensor cores read a .tf32 operand: the low 13 bits cut."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _chained(a, b, terms):
    """a [R, K] @ b [K, C] as the kernel sums it: chains of the f32 tile's
    BK along K, each from 0, added into f32 sums; 3 terms (3xTF32) or 1 (one
    TF32 product)."""
    chain = kernel.BLOCK_TILE[torch.float32][2]
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], chain):
        sa, sb = a[:, k0:k0 + chain], b[k0:k0 + chain]
        a_big, b_big = _tf32(sa), _tf32(sb)
        big = a_big @ b_big
        if terms == 1:
            out += big
        else:
            out += big + _tf32_cut(sa - a_big) @ b_big + a_big @ _tf32_cut(sb - b_big)
    return out


def _emulated_grouped(x, w, offsets, terms):
    bounds = offsets.tolist()
    out = torch.zeros(x.shape[0], w.shape[2])
    for e in range(w.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        out[lo:hi] = _chained(x[lo:hi], w[e], terms)
    return out


def _scale_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("terms,holds", [(3, True), (1, False)], ids=["3xtf32", "tf32"])
def test_3xtf32_grouped_product_holds_the_f32_tolerance(terms, holds):
    """grouped_mm at mixtral's reduction width (K = 4,096) over a few groups,
    one of them empty: 3xTF32 within 1e-5 of the plain version's scale, one
    TF32 product not."""
    r = np.random.default_rng(5)
    k, n, sizes = 4096, 48, [20, 0, 33, 11]
    x = torch.as_tensor((r.normal(size=(sum(sizes), k)) / np.sqrt(k)).astype(np.float32))
    w = torch.as_tensor(r.normal(size=(len(sizes), k, n)).astype(np.float32))
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    err = _scale_err(_emulated_grouped(x, w, offsets, terms), grouped_mm_ref(x, w, offsets))
    assert (err <= ATOL) == holds, f"{terms} term(s): {err:.2e} of scale"


@pytest.mark.parametrize("terms,holds", [(3, True), (1, False)], ids=["3xtf32", "tf32"])
def test_3xtf32_wgrad_reduction_holds_the_f32_tolerance(terms, holds):
    """grouped_mm_wgrad's reduction over one group of 2,048 rows (the rows
    are the chained axis): 3xTF32 within 1e-5 of the plain version's scale,
    one TF32 product not."""
    r = np.random.default_rng(6)
    m, k, n = 2048, 64, 40
    x = torch.as_tensor(r.normal(size=(m, k)).astype(np.float32))
    dy = torch.as_tensor(r.normal(size=(m, n)).astype(np.float32))
    offsets = torch.tensor([0, m], dtype=torch.int32)
    want = grouped_mm_wgrad_ref(x, dy, offsets)[0]
    err = _scale_err(_chained(x.T.contiguous(), dy, terms), want)
    assert (err <= ATOL) == holds, f"{terms} term(s): {err:.2e} of scale"


# ---------------------------------------------------- the tile schedule ----

def _decode_sizes():
    sizes = [0] * 32                        # 16 rows (B = 2 x top_k 8) over 32 experts
    for e, c in {0: 2, 3: 1, 5: 3, 9: 1, 12: 2, 16: 1, 21: 4, 26: 1, 29: 1}.items():
        sizes[e] = c
    return sizes


def _granite_sizes():
    r = np.random.default_rng(9)
    p = r.dirichlet(np.ones(32))
    p[[0, 16]] = 0.0
    return r.multinomial(16384, p / p.sum()).tolist()


# (m, k, n, offsets): empty groups with rows past the last one; one giant
# group; the decode case; rows in no group at both ends; granite's prefill
SCHEDULES = {
    "empty_groups": (300, 70, 33, np.cumsum([0, 0, 100, 0, 150, 0]).tolist()),
    "one_giant_group": (5000, 96, 136, [0, 0, 5000, 5000, 5000]),
    "decode_16_rows_32_experts": (16, 1024, 512, np.cumsum([0] + _decode_sizes()).tolist()),
    "rows_in_no_group": (120, 24, 20, [20, 50, 50, 90]),
    "granite_prefill": (16384, 1024, 512, np.cumsum([0] + _granite_sizes()).tolist()),
}


def _bounds(offs, m):
    out = []
    for lo, hi in zip(offs[:-1], offs[1:]):
        lo = min(max(lo, 0), m)
        out.append((lo, min(max(hi, lo), m)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_forward_schedule_covers_each_group_row_once(case, dtype):
    """Every row of every group is in exactly one tile per column tile, no
    tile straddles a group or exceeds BM rows, the rows in no group are the
    zeroed ranges, and the count never exceeds the grid's bound from the
    shapes alone."""
    m, k, n, offs = SCHEDULES[case]
    bm, bn, _ = kernel.BLOCK_TILE[dtype]
    sched = kernel.tile_schedule(offs, m, k, n, dtype)
    tn = -(-n // bn)
    cover = np.zeros((m, tn), np.int64)
    bounds = _bounds(offs, m)
    for e, r0, r_end, c0 in sched["tiles"]:
        lo, hi = bounds[e]
        assert lo <= r0 < r_end <= hi and r_end - r0 <= bm and c0 % bn == 0 and c0 < n
        cover[r0:r_end, c0 // bn] += 1
    in_group = np.zeros(m, bool)
    for lo, hi in bounds:
        in_group[lo:hi] = True
    assert (cover[in_group] == 1).all() and (cover[~in_group] == 0).all()
    zeroed = np.zeros(m, bool)
    for lo, hi in sched["zero_rows"]:
        assert not zeroed[lo:hi].any()
        zeroed[lo:hi] = True
    assert (zeroed == ~in_group).all()
    assert sched["count"] == len(sched["tiles"]) <= sched["bound"]
    assert sched["bound"] == (-(-m // bm) + len(offs) - 1) * tn
    assert sched["count"] == sum(-(-(hi - lo) // bm) for lo, hi in bounds) * tn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_wgrad_schedule_writes_every_output_tile_once(case, dtype):
    """One tile per (group, K tile, N tile), an empty group's included (it
    writes zeros), each reducing over its group's clamped rows; the count is
    the bound."""
    m, k, n, offs = SCHEDULES[case]
    bm, bn, _ = kernel.BLOCK_TILE[dtype]
    sched = kernel.tile_schedule(offs, m, k, n, dtype, wgrad=True)
    bounds = _bounds(offs, m)
    seen = {(e, i0, j0) for e, i0, j0, _, _ in sched["tiles"]}
    assert len(seen) == sched["count"] == sched["bound"]
    assert seen == {(e, i0, j0) for e in range(len(bounds)) for i0 in range(0, k, bm)
                    for j0 in range(0, n, bn)}
    assert all((lo, hi) == bounds[e] for e, _, _, lo, hi in sched["tiles"])
    assert sched["zero_rows"] == []


def test_wrappers_refuse_more_groups_than_the_kernel_takes():
    with pytest.raises(ValueError, match="at most 1024"):
        kernel._check_groups("grouped_mm", kernel.MAX_GROUPS + 1)
    kernel._check_groups("grouped_mm", kernel.MAX_GROUPS)
