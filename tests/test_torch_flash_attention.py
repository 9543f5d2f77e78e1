"""Port vs reference, flash attention: the port's plain ``flash_attention_ref``
and ``ops.attend`` (CPU tensors take the plain version) against the JAX
package's Pallas kernel in interpret mode (block 32 x 32) and its
``flash_attention_ref``, at the shapes of the reference's own sweep
(tests/test_kernels.py). Same numpy inputs; atol 2e-5 f32 / 3e-2 bf16, the
reference's tolerances. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import inspect
import subprocess
import sys
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import kernel, ops

ROOT = pathlib.Path(__file__).resolve().parent.parent

SWEEP = [
    (2, 64, 4, 4, 32, True, None, "float32"),
    (1, 100, 8, 2, 64, True, None, "float32"),
    (2, 33, 4, 1, 16, True, None, "float32"),
    (1, 128, 4, 4, 64, True, 32, "float32"),
    (1, 96, 2, 2, 128, False, None, "float32"),
    (2, 64, 4, 4, 64, True, None, "bfloat16"),
    (1, 257, 2, 1, 64, True, 100, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(b, s, h, kv, hd, seed, t=None):
    r = np.random.default_rng(seed)
    t = s if t is None else t
    return (r.normal(size=(b, s, h, hd)).astype(np.float32),
            r.normal(size=(b, t, kv, hd)).astype(np.float32),
            r.normal(size=(b, t, kv, hd)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,win,dtype", SWEEP)
def test_plain_version_and_attend_match_the_reference(b, s, h, kv, hd, causal, win, dtype):
    q, k, v = _inputs(b, s, h, kv, hd, s * h)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want_kernel = jax_flash(jq, jk, jv, causal=causal, window=win, interpret=True,
                            block_q=32, block_k=32)
    want_ref = jax_ref(jq, jk, jv, causal=causal, window=win)
    tq, tk, tv = (torch.as_tensor(x).to(tdt) for x in (q, k, v))
    got_ref = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=win)
    got_ops = ops.attend(tq, tk, tv, causal=causal, window=win)
    for got in (got_ref, got_ops):
        assert got.shape == (b, s, h, hd) and got.dtype == tdt
        np.testing.assert_allclose(_f32(got), _f32(want_kernel), atol=TOL[dtype])
        np.testing.assert_allclose(_f32(got), _f32(want_ref), atol=TOL[dtype])


@pytest.mark.parametrize("s,t,causal,win", [(40, 72, False, None), (72, 40, False, 16),
                                           (50, 50, True, 7)])
def test_plain_version_with_other_lengths_and_scale(s, t, causal, win):
    """S != T (the kernel's k_pos < T edge), an explicit scale, a window."""
    q, k, v = _inputs(2, s, 4, 2, 32, s + t, t=t)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jax_ref(jq, jk, jv, causal=causal, window=win, scale=0.3)
    got = fa.flash_attention_ref(*(torch.as_tensor(x) for x in (q, k, v)),
                                 causal=causal, window=win, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_make_attn_impl_signature_and_it_ignores_the_mask():
    impl = fa.make_attn_impl()
    assert list(inspect.signature(impl).parameters) == ["q", "k", "v", "mask", "scale"]
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 24, 4, 2, 16, 3))
    want = fa.flash_attention_ref(q, k, v, causal=True, scale=0.25)
    for mask in (None, torch.zeros(24, 24, dtype=torch.bool), torch.ones(24, 24, dtype=torch.bool)):
        assert torch.equal(impl(q, k, v, mask, 0.25), want)
    windowed = fa.make_attn_impl(window=5)(q, k, v, None, 0.25)
    assert torch.equal(windowed, fa.flash_attention_ref(q, k, v, causal=True, window=5,
                                                        scale=0.25))


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 8, 2, 1, 16, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention(q, k, v)
    assert kernel.launch_counts["flash_attention"] == 0


def test_head_dims_and_the_kernel_table():
    assert kernel.HEAD_DIMS == (16, 32, 64, 128)
    assert set(kernel.SOURCES) == {"flash_attention", "flash_train"}
    assert all(source.is_file() for source in kernel.SOURCES.values())
    from repro_torch import kernels
    assert kernel in kernels.KERNEL_MODULES
    # a source per TPU kernel, eg_solve.cu for the P1 loop over eg_step,
    # grouped_mm.cu for the ragged MoE's products (jax.lax.ragged_dot's port)
    # and flash_train.cu for the train step's attention with its backward
    assert sum(len(m.SOURCES) for m in kernels.KERNEL_MODULES) == 9


def test_module_imports_without_nvcc_or_a_gpu():
    code = ("import sys\n"
            "import repro_torch.kernels.flash_attention as fa\n"
            "from repro_torch.kernels import build\n"
            "assert not fa.kernel._LIBS\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'triton'))\n"
            "assert not bad, bad\n"
            "try:\n"
            "    build.find_nvcc()\n"
            "except RuntimeError:\n"
            "    print('no nvcc')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "",
                                        "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr


# ---------------------------------------------- tensor-core arithmetic ----
# The CUDA kernel runs its products on the tensor cores: f32 by 3xTF32, bf16
# with P split into two bf16 terms. These tests emulate that arithmetic in
# plain torch at a reduced serving shape and hold it to the f32 plain version
# at the kernel's own tolerances, and show that the one-term versions (plain
# TF32, a single bf16 P) would not hold them.

def _tf32(x):
    """Round float32 to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits
    to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, terms):
    """a @ b in f32 from TF32 operands: 1 term (big*big) or 3 (3xTF32)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _bf16_terms(p, terms):
    hi = p.to(torch.bfloat16).float()
    return hi if terms == 1 else hi + (p - hi).to(torch.bfloat16).float()


def _emulated_attention(q, k, v, *, scale, qk, pv):
    """Causal GQA attention with the products ``qk(q, k^T)`` and
    ``pv(p, v)`` supplied; f32 softmax, output in q.dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd).permute(0, 2, 3, 1, 4)
    logits = qk(qg, k.float().permute(0, 2, 3, 1)[:, :, None]) * scale
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    probs = torch.softmax(torch.where(keep, logits, float("-inf")), dim=-1)
    out = pv(probs, v.float().permute(0, 2, 1, 3)[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def test_3xtf32_products_hold_the_f32_tolerance():
    """f32 path: 3xTF32 within 2e-5 of the f32 plain version at B=1, S=512,
    H=4, KV=2, hd=128, causal, scale 0.3; one TF32 product is not."""
    q, k, v = (torch.as_tensor(x) for x in _inputs(1, 512, 4, 2, 128, 14))
    assert torch.equal(_tf32(torch.tensor([1.0, -1.0 - 2.0 ** -11, 1.0 + 2.0 ** -12])),
                       torch.tensor([1.0, -1.0 - 2.0 ** -10, 1.0]))
    want = fa.flash_attention_ref(q, k, v, causal=True, scale=0.3)
    errs = {}
    for terms in (3, 1):
        got = _emulated_attention(q, k, v, scale=0.3,
                                  qk=lambda a, b, n=terms: _mm(a, b, n),
                                  pv=lambda a, b, n=terms: _mm(a, b, n))
        errs[terms] = float((got - want).abs().max())
    assert errs[3] <= 2e-5, errs
    assert errs[1] > 2e-5, errs


def test_bf16_p_in_two_terms_holds_the_serving_check():
    """bf16 path: Q K^T of bf16 values is exact in f32; P V with P = hi + lo
    (two bf16 terms) holds |got - want| <= 2e-5 + 1e-2 |want| everywhere, a
    single bf16 P does not."""
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16) for x in _inputs(1, 512, 4, 2, 128, 15))
    want = fa.flash_attention_ref(q, k, v, causal=True).float()
    excess = {}
    for terms in (2, 1):
        got = _emulated_attention(q, k, v, scale=128 ** -0.5, qk=torch.matmul,
                                  pv=lambda p, b, n=terms: _bf16_terms(p, n) @ b).float()
        excess[terms] = float(((got - want).abs() - 1e-2 * want.abs()).max())
    assert excess[2] <= 2e-5, excess
    assert excess[1] > 2e-5, excess
