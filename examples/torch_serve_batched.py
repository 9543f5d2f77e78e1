"""Batched serving on the PyTorch port: prefill a batch of requests, then
decode tokens for all of them in lock-step, on a reduced config of any
architecture of the registry (the counterpart of ``serve_batched.py``).

Shows the three kinds of decode state: a KV cache (dense / MoE / VLM /
audio), the RWKV recurrent state (attention-free rwkv6) and the hybrid's
KV cache beside its SSM state (hymba). The prefill attends through the
flash-attention kernel on a CUDA device (its plain version on the CPU).

  PYTHONPATH=src python examples/torch_serve_batched.py --arch hymba-1.5b --batch 4
  PYTHONPATH=src python examples/torch_serve_batched.py --smoke --device cpu

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import assigned_architectures, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import make_attn_impl  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import multimodal, transformer  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=assigned_architectures())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings so the run finishes in seconds")
    args = ap.parse_args(argv)
    if args.smoke:
        args.batch, args.prompt_len, args.gen = 1, 8, 4

    device = serve.resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(gen, cfg, device=device)
    b, s = args.batch, args.prompt_len
    prompts = torch.randint(0, cfg.true_vocab_size, (b, s), generator=gen, device=device)
    prefix = None
    if cfg.embed_input:
        raw = torch.randn((b, cfg.frontend_tokens, multimodal.frontend_feature_dim(cfg)),
                          generator=gen, device=device)
        prefix = multimodal.frontend_embeddings(cfg, raw)

    res = serve.generate(params, prompts, cfg, gen=args.gen, prefix_embeds=prefix,
                         attn_impl=make_attn_impl(window=cfg.sliding_window))
    state = [name for name, present in (("KV cache", not cfg.attn_free),
                                        ("RWKV state", cfg.family == "ssm"),
                                        ("SSM state", cfg.hybrid)) if present]
    print(f"{cfg.name} on {device}: prefill {b}x{s} in {res.prefill_s:.2f}s; decode state: "
          f"{' + '.join(state)} of {res.cache_len} positions")
    print(f"decoded {args.gen} tokens x {b} requests in {res.decode_s:.2f}s "
          f"({res.decode_s / max(args.gen, 1) * 1000:.0f} ms/step, batched)")
    for i in range(b):
        print(f"  req{i}: {res.tokens[i, :12].tolist()}...")
    if res.tokens.shape != (b, args.gen):
        raise SystemExit(f"expected {b}x{args.gen} tokens, got {tuple(res.tokens.shape)}")
    print(f"serve_batched OK: {cfg.name} decoded {args.gen}x{b} tokens")


if __name__ == "__main__":
    main()
