"""Serving entry point: prefill a batch of prompts, then decode greedily.

Counterpart of ``repro.launch.serve``, for every architecture of the
registry. ``generate`` is the path: one prefill of ``tokens [B, S]`` (after
the frontend prefix ``[B, P, d]`` of a VLM / audio config) through
``attn_impl`` (on CUDA tensors the flash attention kernel, one launch per
attention layer; none for rwkv6), the decode state padded to ``P + S + gen``
positions, then ``gen`` greedy decode steps (plain attention over the cache;
the recurrent states of rwkv6 and of the hybrid's SSM branch carried over).
Weights are random, drawn from ``--seed``; nothing is downloaded.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --reduced \\
      --device cpu --batch 2 --prompt-len 32 --gen 16

``--device`` defaults to ``cuda`` and raises without a CUDA device; it never
falls back to the CPU. ``main`` prefills through
``kernels.flash_attention.make_attn_impl`` with ``--window``, or the config's
own sliding window (mixtral) when none is given: the counterpart of the
reference's ``build_prefill_step(attn_impl=...)`` on the TPU.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs.registry import ARCHITECTURES, get_config
from ..kernels.flash_attention import make_attn_impl
from ..models import multimodal, transformer
from ..precision import full_f32_matmul

Tensor = torch.Tensor


class ServeResult(NamedTuple):
    tokens: Tensor          # [B, gen] greedy ids: the prefill's argmax, then each step's
    prefill_logits: Tensor  # [B, V] logits at the last prompt position
    last_logits: Tensor     # [B, V] logits of the last decode step (prefill's if gen == 0)
    prefill_s: float        # host clock around the prefill, synchronised
    decode_s: float         # host clock around the gen decode steps, synchronised
    cache_len: int          # decode position at the end: P + S + gen


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pad_cache(state: transformer.DecodeState, cfg, batch: int, max_len: int,
              cache_dtype=torch.float32) -> transformer.DecodeState:
    """The prefill's state with a KV cache of ``max_len`` positions (as the
    reference's serve pads it for generation headroom); the recurrent
    states (rwkv6, the hybrid's SSM) are carried over as they are."""
    device = state.position.device
    full = transformer.init_decode_state(cfg, batch, max_len, cache_dtype=cache_dtype,
                                         device=device)
    kv = None
    if state.kv is not None:
        pl = state.kv.k.shape[2]
        full.kv.k[:, :, :pl] = state.kv.k
        full.kv.v[:, :, :pl] = state.kv.v
        kv = full.kv._replace(length=state.kv.length.expand(full.kv.length.shape).clone())
    return full._replace(kv=kv, rwkv=state.rwkv, ssm=state.ssm, position=state.position)


@torch.no_grad()
def generate(params: dict, tokens: Tensor, cfg, *, gen: int, window: int | None = None,
             attn_impl=None, cache_dtype=torch.float32,
             prefix_embeds: Tensor | None = None) -> ServeResult:
    """Prefill ``prefix_embeds [B, P, d]`` (when given) and ``tokens [B, S]``
    (through ``attn_impl``; the plain attention when None), pad the cache to
    ``P + S + gen``, decode ``gen`` greedy steps. f32 matrix products run in
    full f32 (no TF32)."""
    b, s = tokens.shape
    p = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    device = tokens.device
    with full_f32_matmul():
        _sync(device)
        t0 = time.perf_counter()
        logits, state = transformer.prefill(params, tokens, cfg, prefix_embeds=prefix_embeds,
                                            window=window, attn_impl=attn_impl,
                                            cache_dtype=cache_dtype)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        prefill_logits = logits
        state = pad_cache(state, cfg, b, p + s + gen, cache_dtype)

        out_tokens = []
        cur = torch.argmax(logits, dim=-1)[:, None]
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(gen):
            out_tokens.append(cur)
            logits, state = transformer.decode_step(params, cur, state, cfg)
            cur = torch.argmax(logits, dim=-1)[:, None]
        _sync(device)
        decode_s = time.perf_counter() - t0
    generated = (torch.cat(out_tokens, dim=1) if out_tokens
                 else torch.zeros((b, 0), dtype=torch.long, device=device))
    return ServeResult(tokens=generated, prefill_logits=prefill_logits, last_logits=logits,
                       prefill_s=prefill_s, decode_s=decode_s,
                       cache_len=int(state.position))


def resolve_device(device: str) -> torch.device:
    """``device`` as asked; a CUDA device that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device (torch.cuda.is_available() "
                           "is false); pass --device cpu to run on the CPU")
    return dev


def main(argv: list[str] | None = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ARCHITECTURES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = transformer.init_params(gen, cfg, device=device)
    b, s = args.batch, args.prompt_len
    tokens = torch.randint(0, cfg.true_vocab_size, (b, s), generator=gen, device=device)
    prefix = None
    if cfg.embed_input:
        raw = torch.randn((b, cfg.frontend_tokens, multimodal.frontend_feature_dim(cfg)),
                          generator=gen, device=device)
        prefix = multimodal.frontend_embeddings(cfg, raw)

    window = args.window if args.window is not None else cfg.sliding_window
    res = generate(params, tokens, cfg, gen=args.gen, window=args.window,
                   attn_impl=make_attn_impl(window=window), prefix_embeds=prefix)
    print(f"prefill[{b}x{s}]: {res.prefill_s:.2f}s (cache pos={res.cache_len - args.gen})")
    dt = res.decode_s
    print(f"decode {args.gen} steps: {dt:.2f}s ({dt / max(args.gen, 1) * 1000:.0f} ms/tok)")
    print("generated ids:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
