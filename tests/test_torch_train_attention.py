"""The training attention on the CPU: the plain twins of the training
kernels (``kernels.flash_attention.ref.flash_train_forward_ref`` /
``flash_train_backward_ref``: the forward with its log-sum-exp, the
backward by the kernels' equations) against ``torch.autograd.grad`` of the
model's plain ``_sdpa`` in f32, and the route of the train step's default
attention (``ops.make_train_attn_impl``): on the CPU, in f32 and at a width
pair with no instance it is ``_sdpa`` with the causal mask, bit for bit, and
launches nothing. The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance 2e-5 of each quantity's scale: f32 sums of at most a few hundred
terms taken in another order (the twin forms P from the log-sum-exp, the
softmax from the row max).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.launch import steps, train
from repro_torch.models import attention, layers, transformer

# (B, S, H, KV, dqk, dv, window): granite's widths with GQA 2; Moonlight's with
# one kv head per q head; S off the 64-row tile; causal with and without a window
CASES = [(2, 70, 4, 2, 64, 64, None), (1, 67, 2, 2, 192, 128, None),
         (1, 100, 4, 2, 64, 64, 17), (1, 65, 2, 2, 192, 128, 30),
         (2, 64, 2, 1, 128, 128, None), (1, 130, 2, 1, 128, 128, 64)]
TOL = 2e-5


def _inputs(b, s, h, kv, dqk, dv, seed):
    r = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(r.normal(size=shape).astype(np.float32))
    return mk(b, s, h, dqk), mk(b, s, kv, dqk), mk(b, s, kv, dv), mk(b, s, h, dv)


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * max(scale, 1.0)


@pytest.mark.parametrize("b,s,h,kv,dqk,dv,win", CASES)
def test_plain_twins_match_autograd_of_sdpa(b, s, h, kv, dqk, dv, win):
    q, k, v, do = _inputs(b, s, h, kv, dqk, dv, s * dqk + h)
    scale = 0.3
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = layers.causal_mask(s, s, 0, win)
    want = attention._sdpa(*leaves, mask, scale)
    want_grads = torch.autograd.grad(want, leaves, do)
    o, lse = ref.flash_train_forward_ref(q, k, v, window=win, scale=scale)
    assert o.shape == (b, s, h, dv) and lse.shape == (b, h, s) and lse.dtype == torch.float32
    _close(o, want.detach())
    logits = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(h // kv, dim=2)) * scale
    _close(lse, torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1))
    grads = ref.flash_train_backward_ref(q, k, v, o, lse, do, window=win, scale=scale)
    for got, w, x in zip(grads, want_grads, (q, k, v)):
        assert got.shape == x.shape and got.dtype == x.dtype
        _close(got, w)


def test_twin_backward_keeps_its_input_dtypes():
    q, k, v, do = (x.to(torch.bfloat16) for x in _inputs(1, 40, 2, 1, 64, 64, 5))
    o, lse = ref.flash_train_forward_ref(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert all(g.dtype == torch.bfloat16
               for g in ref.flash_train_backward_ref(q, k, v, o, lse, do))


@pytest.mark.parametrize("dtype,widths,win", [(torch.float32, (64, 64), None),
                                              (torch.bfloat16, (64, 64), None),
                                              (torch.bfloat16, (192, 128), 9),
                                              (torch.bfloat16, (64, 32), None)])
def test_train_adapter_on_the_cpu_is_sdpa_with_the_causal_mask(dtype, widths, win):
    q, k, v, do = (x.to(dtype) for x in _inputs(1, 33, 4, 2, *widths, 11))
    assert not kernel.train_takes(q, k, v)
    kernel.reset_launch_counts()
    impl = ops.make_train_attn_impl(window=win)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = impl(*leaves, None, 0.25)
    got_grads = torch.autograd.grad(got, leaves, do)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = attention._sdpa(*leaves, layers.causal_mask(33, 33, 0, win), 0.25)
    want_grads = torch.autograd.grad(want, leaves, do)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    assert all(n == 0 for n in kernel.launch_counts.values())


def test_train_wrapper_refuses_cpu_tensors():
    q, k, v, _ = (x.to(torch.bfloat16) for x in _inputs(1, 16, 2, 1, 64, 64, 0))
    kernel.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_train_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_train_forward(q, k, v)
    assert all(n == 0 for n in kernel.launch_counts.values())


def test_train_widths():
    assert kernel.TRAIN_WIDTHS == ((64, 64), (128, 128), (192, 128))
    assert set(kernel.launch_counts) == {"flash_attention", "flash_train_fwd",
                                         "flash_train_dq", "flash_train_dkdv"}


def _round(cfg, attn_impl, compute_dtype, seed=0, v=2):
    """One DDS round of ``cfg`` on the CPU from a seeded state; the updated
    parameters, moments and metrics."""
    gen = torch.Generator().manual_seed(seed)
    params, opt, sm = steps.init_train_state(cfg, v, gen)
    tokens = torch.randint(0, cfg.true_vocab_size, (v, 2, 24), generator=gen)
    ts = steps.build_dds_train_step(cfg, lr=1e-3, p1_steps=20, attn_impl=attn_impl,
                                    compute_dtype=compute_dtype)
    p, o, new_sm, metrics = ts.fn(params, opt, sm, tokens, train.ring_contact(v, "cpu"),
                                  torch.full((v,), 1.0 / v))
    return steps.flatten(p), steps.flatten(o.mu), new_sm, metrics


def _sdpa_impl(cfg):
    """What the model attends with when handed no ``attn_impl``."""
    def impl(q, k, v, mask, scale):
        s = q.shape[1]
        return attention._sdpa(q, k, v, layers.causal_mask(s, s, 0, cfg.sliding_window), scale)
    return impl


@pytest.mark.parametrize("arch,compute_dtype", [("granite-moe-1b-a400m", None),
                                                ("granite-moe-1b-a400m", torch.bfloat16),
                                                ("moonlight-16b-a3b", torch.bfloat16),
                                                ("mixtral-8x7b", torch.bfloat16)])
def test_train_step_default_attention_on_the_cpu_is_sdpa_bit_for_bit(arch, compute_dtype):
    """The default (``attn_impl=None``) round against one through ``_sdpa``
    with the causal mask at the config's window (mixtral's, 64 reduced):
    loss, state matrix, parameters and moments equal, no launch."""
    cfg = get_config(arch).reduced()
    kernel.reset_launch_counts()
    got = _round(cfg, None, compute_dtype)
    want = _round(cfg, _sdpa_impl(cfg), compute_dtype)
    assert all(n == 0 for n in kernel.launch_counts.values())
    assert torch.equal(got[3]["loss"], want[3]["loss"]) and torch.equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        assert all(torch.equal(a[name], b[name]) for name in b)


def test_train_step_lm_loss_gradients_through_the_default_adapter_are_sdpa_bit_for_bit():
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b").reduced(), head_dim=192,
                              qk_rope_dim=64, v_head_dim=128)
    gen = torch.Generator().manual_seed(3)
    params = {n: x.to(torch.bfloat16) for n, x in steps.flatten(
        transformer.init_params(gen, cfg)).items()}
    tokens = torch.randint(0, cfg.true_vocab_size, (1, 20), generator=gen)

    def loss_and_grads(attn_impl):
        leaves = {n: x.clone().requires_grad_() for n, x in params.items()}
        loss = transformer.lm_loss(steps.unflatten(leaves), tokens, cfg, remat=True,
                                   attn_impl=attn_impl)
        return loss, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                         materialize_grads=True)

    got, want = loss_and_grads(ops.make_train_attn_impl()), loss_and_grads(None)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


def test_an_explicit_attn_impl_wins_over_the_default():
    cfg = get_config("granite-moe-1b-a400m").reduced()
    calls = []
    blocked = attention.make_blocked_impl(block=16)

    def recording(q, k, v, mask, scale):
        calls.append(mask)
        return blocked(q, k, v, mask, scale)

    got = _round(cfg, recording, None)
    # forward and remat's recompute of each layer, for each of the 2 vehicles
    assert len(calls) == 2 * cfg.num_layers * 2 and all(m is None for m in calls)
    want = _round(cfg, None, None)
    assert abs(float(got[3]["loss"]) - float(want[3]["loss"])) <= 1e-5
