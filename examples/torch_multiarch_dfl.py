"""DFL-DDS is architecture-agnostic, on the PyTorch port: run federated
rounds over any of the 10 assigned architectures (reduced variants) with the
SAME launch-layer train step that the multi-pod dry run steps through (the
counterpart of ``multiarch_dfl.py``; ``mesh=None`` is the one-device step
where the reference builds a one-device mesh).

  PYTHONPATH=src python examples/torch_multiarch_dfl.py --archs qwen3-1.7b rwkv6-3b mixtral-8x7b
  PYTHONPATH=src python examples/torch_multiarch_dfl.py --smoke --device cpu

``--device`` defaults to ``cuda`` and raises without a CUDA device.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import assigned_architectures, get_config  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.serve import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*", default=["qwen3-1.7b", "rwkv6-3b",
                                                   "granite-moe-1b-a400m"],
                    choices=assigned_architectures())
    ap.add_argument("--vehicles", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny settings so the run finishes in seconds")
    args = ap.parse_args(argv)
    if args.smoke:
        args.vehicles, args.rounds, args.seq_len = 2, 1, 16
    device = resolve_device(args.device)

    v = args.vehicles
    eye = torch.eye(v, device=device)
    contact = torch.clamp(eye + eye.roll(1, 1) + eye.roll(-1, 1), max=1.0)   # a ring
    target = torch.full((v,), 1.0 / v, device=device)

    losses = {}
    for arch in args.archs:
        cfg = get_config(arch).reduced()
        ts = steps_lib.build_dds_train_step(cfg, mesh=None, lr=1e-3, remat=False,
                                            p1_steps=60)
        gen = torch.Generator(device=device).manual_seed(0)
        params, opt_state, sm = steps_lib.init_train_state(cfg, v, gen, device=device)
        print(f"--- {arch} ({cfg.family}) reduced: d={cfg.d_model} L={cfg.num_layers}")
        for it in range(args.rounds):
            tokens = torch.randint(0, cfg.true_vocab_size, (v, 2, args.seq_len),
                                   generator=gen, device=device)
            extra = ()
            if cfg.embed_input:
                extra = (0.02 * torch.randn((v, 2, cfg.frontend_tokens, cfg.d_model),
                                            generator=gen, device=device),)
            t0 = time.time()
            params, opt_state, sm, m = ts.fn(params, opt_state, sm, tokens, contact,
                                             target, *extra)
            loss, kl = float(m["loss"]), float(m["kl"])    # waits for the round
            print(f"  round {it}: loss={loss:.4f} mean-KL={kl:.4f} ({time.time()-t0:.1f}s)")
            losses[arch] = loss
    print(f"multiarch_dfl OK: {len(args.archs)} architectures x {args.rounds} rounds "
          f"on {device}")
    return losses


if __name__ == "__main__":
    main()
