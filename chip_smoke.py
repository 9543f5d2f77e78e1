#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # needs one CUDA device; exit 0 = all phases passed
    python3 chip_smoke.py --cpu-rehearsal # tiny sizes on the CPU, no kernels: checks this
                                          # script's control flow only, always exits 3
    python3 chip_smoke.py --kernels-only  # phases 1-3 only, exits 3

Phases, each of which fails the run (non-zero exit) when it fails:

1. device    — a CUDA device must be present; prints its name and power limit.
2. build     — compiles every CUDA kernel from the sources in this checkout,
               one ``nvcc`` per source, all started together.
3. kernels   — every kernel against its plain PyTorch version on the card, at
               the reference's test shapes and at the main path's shapes
               (tolerance: f32 atol 1e-5, bf16 atol 5e-2; flash attention f32
               2e-5, bf16 3e-2), the grouped launches over groups of leaves,
               the one-launch P1 solve up to the library's limit, the two mixes
               with the seed axis (S=3 seeds in one launch; also on the
               zero-diagonal mixing of delayed gossip, with a row of no
               contact), the two mixes on every rank's per-shard block at N = 2
               and 4 (W ``[100, 50]`` / ``[100, 25]``, ids remapped and clipped
               into ``[0, 50)`` / ``[0, 25)``; the partials sum to the global
               mix), the wrappers' refusals, and each kernel's time there (kl_simplex kernels also
               at K = 1024, ``kl_rows`` / ``entropy_rows`` on the launcher's
               other paths — K off the 16-byte loads, bases off 16 bytes, g
               staged in chunks at K = 65,536, V = K = 1 — and their launch
               floor at V = 1, K = 32; the P1 solve per 200-step solve; flash attention at
               the serving shape B=4, S=T=2048, H=16, KV=8, hd=128); flash attention
               also at the zoo's prefill shapes (hd 64 with G = 1, 2, 5; hd 128 with
               G = 6; prefixes of 64 / 256 positions; mixtral's 4,096 window);
               the train step's attention (``flash_train_fwd``, ``flash_train_bwd``:
               the dQ then dK / dV launches) at cells 6's and 2's per-layer shapes
               against the exact f32 result and ``_sdpa``'s own error, its backward
               the same bits twice, timed beside ``_sdpa`` and the library call.
               ``gossip_mix_matmul``'s column mapping (few rows): K = 1-17 over
               ragged widths on both sides of its limit, the mapping the launcher
               picked printed per case, in place equal to out of place bit for
               bit, S=3 seeds at K=4, ``[4, 100]`` and ``[8, 2]`` Ws, an
               unaligned leaf; the aliasing refusals, by the wrapper and by the C
               launcher; K=100's shapes (rows 2, 2s, 2r) on the tile mapping;
               the crossover: per K and dtype, the launcher's mapping against the
               tiles (W padded with zero rows to the tiles' smallest K_out) on the
               CNN round's 8 leaves and on 4 leaves of 2^23 columns, each beside
               its bound. ``grouped_mm`` (also transposed: the input gradient) and
               ``grouped_mm_wgrad`` at the MoE prefill shapes of granite-moe (M =
               2 x 1,024 x 8, E=32, 1,024 -> 512) and mixtral (M = 2 x 1,024 x 2,
               E=8, 4,096 -> 14,336), two experts empty, and at granite-moe's
               decode step (16 rows over 32 experts), f32 (3xTF32, 1e-5 of the
               plain version's scale) and bf16 (atol 5e-2, rtol 3e-2), each
               timed beside its bound (by the design that runs), its plain loop
               and ``torch._grouped_mm`` where the card's torch takes the dtype
               (else the loop), with its working tiles against the persistent
               grid. The AdamW kernel (row 8) at one vehicle step of cells 6's
               and 2's leaves against the train step's per-leaf loop, bit for
               bit, timed beside its bound, the loop and ``torch._fused_adamw_``;
               the train phases, the mesh's included, check its launches
               (V x ceil(leaves / 64) a round).
4. main path — ``run_simulation`` of one DFL-DDS federation at the paper's
               full width (K=100 vehicles, the 21,840-parameter MNIST CNN, E=8,
               B=80, 200 P1 steps, the full-size synthetic MNIST), a few epochs,
               once per contact format, through the gossip-mix kernels (one
               grouped launch per round over the model's 8 leaves, gather or
               matmul) and through ``eg_solve`` (one launch per round's P1
               solve, by ``core.kl_solver.solve_counts`` no eager solve); checks
               the launch counters, the traces and the state matrix, the
               agreement of the two formats and of the kernel path with the
               plain-torch mix.
5. P1        — ``core.kl_solver.solve_p1_all`` on the dense run's final
               state matrix, target and next contact matrix (one ``eg_solve``
               launch, no ``eg_step``), and on a seeded K = 300 case past the
               one-launch limit (its loop: one ``eg_step`` launch per step):
               each one's per-row objective against the plain loop
               (``kernels.kl_simplex.ref.eg_iterate`` over ``eg_step_ref``),
               alpha on the simplex and 0 off the contacts; wall time and
               device events of the one-launch solve, of the loop over
               ``eg_step`` at the same K, of that loop replayed from a CUDA
               graph and of the plain loop.
6. baselines — ``run_simulation`` of ``dfl``, ``d_sgd``, ``d_fedavg`` and ``sp`` at the
               same full width, 2 epochs, both contact formats, through the
               gossip-mix kernels (one grouped launch per round);
               seconds per epoch of each.
6b. seeds    — ``engine.run_seeds`` of S=3 ``dds`` federations at the same full
               width, 4 epochs, once per contact format, then with
               ``overlap="delayed"`` (sparse): each gossip-mix kernel launches
               once per round for all three seeds (4 launches, not 12), and
               each seed's ``kl_divergence`` / ``entropy`` / ``comm_mb`` agree
               with a single run of that seed on the card (atol 1e-5);
               seconds per epoch of the batch and of the single runs, peak
               device memory. The delayed anchor (W = I, p_drop = 1) bit for
               bit through the kernels at full width and end to end at a small
               size. Then the port's smoke campaign (figures 2, 3, 8, 9, 10 and
               overlap; K=8, 15 epochs, seeds 0 1 2, forced, into a store in a
               temporary directory): every scenario must finish with finite
               trajectories; the ordering checks are printed as n_passed /
               n_checks and do not gate the exit code.
6c. sharded  — the shard_map backend (``run_with_context``, ``backend="shard_map"``)
               at the same full width, 4 epochs, on N = 2 and then 4 ranks: one
               process each, spawned after the build, all on this one card,
               talking gloo with the collectives staged through host memory
               (the transport is printed; one card cannot hold two NCCL ranks).
               ``dds`` sparse, dense and sparse with ``overlap="delayed"``. Every
               rank returns the same result; its ``kl_trace`` / ``comm_mb`` /
               ``entropy`` / ``kl_divergence`` equal the vmap run's to 1e-5, its
               average accuracy within 0.02; each rank launches its mix kernel
               once per round and bucket. Per rank: seconds per epoch and the
               phase split, ``reduce_scatter`` included. N ranks time-slicing
               one card is a correctness run, not a scaling figure.
6d. cost model — ``roofline.scenario_cost`` and ``execution="auto"`` on the card:
               the constants of the committed ``H100`` profile as this run
               measures them (the main path's spans and wall time, the gather
               and matmul rows, the id-table ``eg_solve`` row's time per step,
               the eager P1's host time per device event and per step, the
               contact stream timed on the host, the sharded phase's
               reduce-scatters), printed beside the committed ones; the plan
               ``resolve_auto`` makes at K=100 and its predicted epochs/s beside
               the measured s/epoch of the candidate it chose; an auto
               ``run_simulation`` against the manual run it resolved to (1e-5);
               sparse against dense predicted and measured at K=100 (the main
               path's two runs) and at the reference's scale workload
               (``bench_scale_config``, K=1024, ``scale_grid`` of side 32, 8,192
               synthetic MNIST samples, 2 epochs after a 1-epoch warm-up, with
               its phase split), as the table ``predicted_vs_measured_table``
               renders — a ranking ``MISMATCH`` fails the run, as the
               reference's cost-model CLI exits 1 on one; then ``python -m
               repro_torch.launch.train --arch mnist-cnn --vehicles 100 --epochs
               2 --eval-every 1`` into a temporary checkpoint directory, the
               checkpoint restored and held to the history the run printed.
7. diagnostics — ``kl_rows`` / ``entropy_rows`` through their kernels on every
               algorithm's final state matrix, held to that run's last
               ``kl_divergence`` / ``entropy`` diagnostics; then small federations
               (``dds``, ``sp``, ``d_sgd``; RSU + dropped exchanges) on the card
               against the CPU.
8. serve     — qwen3-1.7b at full width (28 layers, d_model 2048, vocab 151,936;
               random f32 weights from a seeded generator on the card) through
               ``launch.serve.generate``: B=4 prompts of 2,048 tokens prefilled
               through the flash-attention kernel (28 launches, one per layer),
               32 greedy decode steps (no launch); the kernel-path prefill against
               the plain-attention prefill (last logits atol 2e-3), prefill + one
               decode step against ``forward`` at B=1, S=256 (atol 2e-3), and the
               reduced config on the card against the CPU (atol 1e-4, same tokens).
8b. zoo      — every other family through ``launch.serve.generate`` at full width
               (d_model, heads, d_ff, experts and vocabulary as published; random
               f32 weights from a seeded generator on the card), each freed before
               the next: granite-moe-1b-a400m (24 layers), rwkv6-3b (32), hymba-1.5b
               (32), musicgen-large (48, 64 prefix positions), mixtral-8x7b (4 of 32
               layers) and internvl2-26b (8 of 48, 256 prefix positions) -- depth cut
               only where the f32 weights do not fit on the card, and printed. B=2
               prompts of 1,024 tokens after the frontend prefix, 16 greedy steps;
               ``flash_attention`` once per attention layer of the prefill and never
               in decode (none for rwkv6); the kernel-path prefill against the
               plain-attention prefill (last logits atol 2e-3); prefill + one decode
               step against ``forward`` at B=1, S=256 (atol 2e-3; rwkv6-3b on its
               first 8 layers, its full depth reported beside its rounding noise);
               the reduced config on the card against the CPU (atol 1e-4, same
               tokens); for granite-moe the ragged MoE against the dense one on the
               card (atol 1e-4). Per model one ``[zoo]`` line: prefill s and
               tokens/s, decode ms/token, peak memory, launches, the differences.
8c. train    — DFL-DDS training of vehicle transformers at full width (published
               widths, random f32 weights from a seeded generator on the card), V=2
               vehicles on a ring, B=2 sequences of 1,024 tokens per vehicle, E=1,
               3 rounds, lr 1e-3, 100 P1 steps: qwen3-1.7b (28 layers, remat, the
               vehicles moved apart from one init) through
               ``launch.steps.build_dds_train_step``, and granite-moe-1b-a400m (24
               layers, 32 experts top-8 with the aux loss) through the train CLI's
               entry point (``launch.train.main``, in this process). Each run: finite
               loss and kl every round, state rows summing to 1 (1e-5), parameters
               that moved, one grouped ``gossip_mix_matmul`` launch per round and no
               flash launch; qwen3's stack mixed in place (every leaf where it was
               after the rounds; a mix of the stack allocates under 1 MiB, printed
               beside the functional mix's and the mix span); qwen3's first-round
               mix through the kernel in place against ``aggregation.mix_params``
               on the stacked leaves (1e-5, a leaf at a time), and the kernel
               timed at that shape (row ``gossip_mix_matmul/train``: V=2 rows, 2.03 B
               columns in one launch, in place as the round runs it and out of
               place, in place equal to out of place bit for bit); one ``[train]``
               line per model (layers, V, s/round with the first round apart, loss
               / kl per round, peak memory, launches). Then one round of every
               reduced architecture (4 vehicles mid-training; every leaf in place)
               on the card against the CPU (atol 1e-4 on loss, kl, state matrix and
               parameters), the reduced qwen3 at V=17 (past the column mapping: its
               mix through the tiles, copied back) the same way, and the
               ``gossip_bf16`` variant's round of the reduced
               qwen3 against its f32 round (2e-2 of each leaf's scale).
8d. mesh-train — the train phase's qwen3-1.7b round on a federation mesh: a
               one-rank NCCL group on the card, ``make_federation_mesh(vehicle=1,
               fsdp=1, model=1, explicit=True)``, ``build_dds_train_step(cfg,
               mesh=mesh)`` from the train phase's seeded first-round state placed
               by ``convert.place_train_state`` (both vehicles local rows, every
               leaf a DTensor; the mix ``steps.mix_rows``, in place through
               ``mix_params_cuda_`` as without the mesh): two rounds, the first's
               loss, kl and the parameters' first 4,096 entries per leaf within
               1e-5 of the mesh-less round 1, the second timed apart from it
               (DTensor's first-call dispatch against its steady state),
               ``gossip_mix_matmul`` launched, no flash launch; s/round, peak MiB
               and the four phase spans of each round printed. Then the mesh mix
               on the second round's own inputs against ``aggregation.mix_params``
               (1e-5) and timed (row ``gossip_mix_matmul/mesh``). Then one round
               of every reduced architecture on the same mesh against its
               mesh-less round on the card (1e-5). The group is torn down and the
               meshes forgotten.
8e. dryrun   — ``python -m repro_torch.launch.dryrun`` in subprocesses started
               after the build (they run on the host, beside the card's phases,
               with no card visible): qwen3-1.7b at ``train_4k``, ``prefill_32k``
               and ``decode_32k`` on the production meshes (a ``fake`` group of
               256 ranks, meta tensors) and mixtral-8x7b at ``train_4k`` (vehicle 2
               x fsdp 8), and granite-moe-1b-a400m at ``decode_32k`` with the
               ``ragged_moe`` variant (the grouped products as custom ops on meta
               tensors); then ``python -m repro_torch.roofline.analysis`` on the
               records. Each pair: exit 0, no ``error``; a train pair's
               ``flops_per_device`` x 256 at least its ``model_flops`` and a
               ``reduce-scatter`` (the gossip mix); a serving pair at least one
               collective. Each record is printed with its H100 roofline row
               (dominant term, useful ratio) and ``run_s``.
8f. ragged   — granite-moe-1b-a400m at full width (24/24 layers, random f32
               weights from a seeded generator) with ``moe_impl="ragged"``: B=2 x
               1,024 tokens prefilled and 16 greedy steps through
               ``launch.serve.generate`` (``grouped_mm`` 3 times per layer per
               forward, 1,224 launches), against the dense MoE on the same weights
               (prefill logits atol 1e-3, the same tokens), prefill s, decode
               ms/token, peak memory of each; then 3 DDS rounds of V=2 vehicles, B=2
               x 1,024 tokens, E=1 (``steps.build_dds_train_step``, remat) through
               the kernels forward and backward (``grouped_mm_wgrad`` once per
               product, vehicle and round) and the same rounds with the dense MoE
               from the same init and tokens: round 1's loss within 1e-4, s/round
               and peak memory of each. Before the rounds, vehicle 0's gradients
               from that init on round 1's tokens, ragged against dense routed as
               the ragged run: every leaf within 1e-3 of its largest |gradient|;
               against dense routing itself, the (token, layer) pairs whose experts
               differ and the gradients' distance, read (``check_ragged_grads``);
               after the rounds, round 1's parameter change of each, in units of lr.
               Then the same 3 rounds under the ``opt_ragged`` variant (bf16
               compute on the f32 master weights, the bf16 gossip payload, the
               ragged MoE) from the same init and tokens: the bf16 grouped
               kernels' launches counted by dtype, the train step's attention
               through the training kernels (2 L V forward launches a round,
               forward and remat's recompute, and L V of each backward kernel; none
               in the f32 rounds), finite losses, round 1's loss within 1e-2 of the
               f32 ragged run's, s/round and peak memory.
8g. examples — every ``examples/torch_*.py`` with ``--smoke --device cuda`` as a
               subprocess, as a user starts it: exit 0 and its ``OK`` line.
9. prints one ``{"kernels": [...]}`` line (the two mixes also as
   ``<name>/shard`` rows: one rank's partial mix at N = 2, N = 4 under ``n4``,
   launches of the sharded phase; ``gossip_mix_matmul/train``: the train
   phase's; ``gossip_mix_matmul/mesh``: the mesh rounds' launches, the mesh
   round's mix checked and timed on its own inputs; ``grouped_mm`` and
   ``grouped_mm_wgrad``: the ragged phase's launches, timed at granite-moe's f32
   prefill shape, every shape and dtype under ``shapes``), the card's name and
   power limit, and as the last line ``{"ok": true, "device": {...}}``.

Every path is driven with the launch counters set to 0 just before it and
read just after. Times are CUDA-event times on the card the script ran on;
the bound of a kernel is the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s for f32 (flash attention's and the grouped
products' f32: three TF32 products per product over 495 TFLOP/s; 989 TFLOP/s
for bf16 inputs: the tensor cores' rate) — published peaks of one H100 SXM at
its full power limit, read from ``repro_torch.roofline.hw``.
"""
from __future__ import annotations

import argparse
import atexit
import ctypes
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert, kernels as kernels_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ARCHITECTURES  # noqa: E402
from repro_torch.core import aggregation, contacts as contacts_lib, dfl_dds, kl_solver  # noqa: E402
from repro_torch.core import vehicle_axis  # noqa: E402
from repro_torch.data import datasets as data_lib  # noqa: E402
from repro_torch.data.synthetic import Dataset, synthetic_mnist  # noqa: E402
from repro_torch.fed import engine, topology  # noqa: E402
from repro_torch.fed.simulator import SimulationConfig, run_simulation  # noqa: E402
from repro_torch.figures import common as figures_common  # noqa: E402
from repro_torch.kernels import adamw as adamw_lib  # noqa: E402
from repro_torch.kernels import build as build_lib  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import grouped_mm as gmm  # noqa: E402
from repro_torch.kernels import kl_simplex  # noqa: E402
from repro_torch.kernels.gossip_mix import kernel, ops, ref  # noqa: E402
from repro_torch.launch import campaign as campaign_lib, serve, steps, variants  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, multimodal, transformer  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.optim import adamw as optim_adamw  # noqa: E402
from repro_torch.precision import full_f32_matmul  # noqa: E402
from repro_torch.profiling import PhaseTimer  # noqa: E402
from repro_torch.roofline import analysis as roofline, hw, scenario_cost  # noqa: E402

ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
EPOCHS = 4                    # depth of the main-path runs: two evals at eval_every=2
BASELINE_EPOCHS = 2           # depth of each baseline run, evaluated every epoch
BASELINES = ("dfl", "d_sgd", "d_fedavg", "sp")
P1_K_PAST_LIMIT = 300         # a P1 problem past eg_solve's limit: the per-step path
SEEDS = (0, 1, 2)             # the seed axis of the seeds phase (run_seeds)
LN2 = float(np.log(2.0))
# the MNIST CNN's eight leaves, flattened: conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b
LEAF_WIDTHS = [250, 10, 5000, 20, 16000, 50, 500, 10]

KERNELS = {
    "gossip_mix_gather": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix_gather.cu",
        "replaces": "src/repro/kernels/gossip_mix/kernel.py:92",
    },
    "gossip_mix_matmul": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix_matmul.cu",
        "replaces": "src/repro/kernels/gossip_mix/kernel.py:39",
    },
    "eg_step": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/kl_simplex/csrc/eg_step.cu",
        "replaces": "src/repro/kernels/kl_simplex/kernel.py:112",
    },
    "eg_solve": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/kl_simplex/csrc/eg_solve.cu",
        "replaces": "src/repro/kernels/kl_simplex/kernel.py:112",
    },
    "kl_rows": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/kl_simplex/csrc/kl_rows.cu",
        "replaces": "src/repro/kernels/kl_simplex/kernel.py:51",
    },
    "entropy_rows": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/kl_simplex/csrc/entropy_rows.cu",
        "replaces": "src/repro/kernels/kl_simplex/kernel.py:76",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:87",
    },
    # the train step's causal attention, forward and backward: no TPU kernel
    # (the Pallas flash_attention is forward only; the reference trains
    # through its plain attention)
    "flash_train_fwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_train.cu",
        "replaces": "not a TPU kernel (the plain training attention, models/attention._sdpa)",
    },
    "flash_train_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_train.cu",
        "replaces": "not a TPU kernel (autograd of models/attention._sdpa): "
                    "flash_train_dq then flash_train_dkdv",
    },
    # the port of jax.lax.ragged_dot (the reference's moe_ragged), not of a Pallas kernel
    "grouped_mm": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_mm/csrc/grouped_mm.cu",
        "replaces": "not a TPU kernel (jax.lax.ragged_dot, src/repro/models/moe.py:94-96)",
    },
    "grouped_mm_wgrad": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/grouped_mm/csrc/grouped_mm.cu",
        "replaces": "not a TPU kernel (the weight gradient of jax.lax.ragged_dot, "
                    "src/repro/models/moe.py:94-96)",
    },
    # the train step's AdamW: the reference leaves it to XLA
    "adamw": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/adamw/csrc/adamw.cu",
        "replaces": "not a TPU kernel (optim.adamw's eager ops and apply_updates, leaf by "
                    "leaf, in launch/steps' local_train)",
    },
}

# the serving path: qwen3-1.7b at full width, B prompts of S tokens, GEN greedy steps
SERVE_ARCH = "qwen3-1.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
# the zoo phase: every other family at full width, B prompts of S tokens (after the
# frontend prefix of a VLM / audio config), GEN greedy steps. Per architecture: the
# depth run (None: all layers) -- cut only where the f32 weights do not fit on one
# 80 GB card with the phase's working set (mixtral 174 GiB, internvl2 74 GiB whole) --
# and the depth of the prefill -> decode handoff check (None: the depth run). rwkv6-3b
# with random weights amplifies rounding with depth: at 32 layers a change of 8 f32
# ulps of its embeddings moves the logits by more than the check's 2e-3 (the phase
# measures and prints that noise), so its handoff is held on the first 8 of its
# full-width layers and reported beside the noise at full depth.
ZOO = (("granite-moe-1b-a400m", None, None), ("rwkv6-3b", None, 8),
       ("hymba-1.5b", None, None), ("musicgen-large", None, None),
       ("mixtral-8x7b", 4, None), ("internvl2-26b", 8, None))
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 2, 1024, 16
# the train phase: DFL-DDS rounds of V vehicle transformers at full width. qwen3-1.7b
# through steps.build_dds_train_step (f32 parameters plus AdamW moments are 6 copies
# of an 8.13 GB model at V=2, mixed in place; 7 with one vehicle's gradients in local
# training, plus activations), granite-moe through
# the train CLI's entry point; B sequences of S tokens per vehicle, E=1, ROUNDS
# rounds, the CLI's lr and P1 steps; then one round of every reduced architecture,
# card against CPU
TRAIN_ARCH, TRAIN_CLI_ARCH = "qwen3-1.7b", "granite-moe-1b-a400m"
TRAIN_V, TRAIN_B, TRAIN_S, TRAIN_ROUNDS, TRAIN_LR, TRAIN_P1 = 2, 2, 1024, 3, 1e-3, 100
TRAIN_SMALL_K = tuple(range(1, 18))   # both sides of the column mapping's limit
TRAIN_SMALL_WIDTHS = [1, 63, 65, 1000, 4097, 100003]
# flash attention: the reference's sweep (tests/test_kernels.py), b, s, h, kv, hd,
# causal, window, dtype; its tolerances
FA_SWEEP = [(2, 64, 4, 4, 32, True, None, torch.float32),
            (1, 100, 8, 2, 64, True, None, torch.float32),
            (2, 33, 4, 1, 16, True, None, torch.float32),
            (1, 128, 4, 4, 64, True, 32, torch.float32),
            (1, 96, 2, 2, 128, False, None, torch.float32),
            (2, 64, 4, 4, 64, True, None, torch.bfloat16),
            (1, 257, 2, 1, 64, True, 100, torch.float32)]
FA_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# flash attention at the zoo's prefill shapes, f32: b, s (prefix included), h, kv, hd,
# window -- hd=64 with G=2 (granite-moe 16/8), G=5 (hymba 25/5: one q-head per block)
# and G=1 after a 64-position prefix (musicgen 32/32); hd=128 with G=6 after a
# 256-position prefix (internvl2 48/8); mixtral's 4,096 window (32/8) at S=1,024 and
# past it at S=4,200
ZOO_FA_SHAPES = [(2, 1024, 16, 8, 64, None), (2, 1024, 25, 5, 64, None),
                 (2, 64 + 1024, 32, 32, 64, None), (2, 256 + 1024, 48, 8, 128, None),
                 (2, 1024, 32, 8, 128, 4096), (1, 4200, 32, 8, 128, 4096)]

# the sharded phase: N ranks of the shard_map backend, each a process of its
# own, all on the one card, talking gloo through host memory (NCCL cannot run
# two ranks on one card)
SHARD_COUNTS = (2, 4)
SHARD_TRANSPORT = "gloo_staged"
# (contact format, overlap, comm_bucket_mb): 8 MiB holds a rank's 8 leaves in one
# bucket at both rank counts (4.37 MB at N=2): one mix launch and one
# reduce-scatter per round; the delayed run keeps the default 4 MiB, two
# pipelined buckets at N=2 (one at N=4)
SHARD_RUNS = (("sparse", "sync", 8.0), ("dense", "sync", 8.0), ("sparse", "delayed", 4.0))
# average accuracy of a sharded run against the vmap run: the partial sums are
# added in another order (1-ulp differences in the mixed parameters) and 4
# rounds x E=8 local SGD steps amplify them (two correct mixes differ by up to
# 1.9e-3 in a parameter after 8 steps, PERF.md); 0.02 is 40 of the 2,000 eval
# samples of the vehicle mean. The state side is deterministic: 1e-5.
SHARD_ACC_ATOL = 0.02
SHARD_TIMEOUT_S = 300.0       # a collective waits this long for the other ranks

# the ragged phase: the grouped products at the MoE prefill shapes (arch, M = B x S x
# top_k rows, E experts, d -> f), 2 x 1,024 tokens as the zoo phase prefills; then
# granite-moe at full width through moe_impl="ragged", served and trained
RAGGED_ARCH = "granite-moe-1b-a400m"
RAGGED_SHAPES = ((RAGGED_ARCH, 2 * 1024 * 8, 32, 1024, 512),
                 ("mixtral-8x7b", 2 * 1024 * 2, 8, 4096, 14336))
# granite-moe's decode step: B=2 tokens x top_k 8 rows over its 32 experts
RAGGED_DECODE_SHAPE = (RAGGED_ARCH, 2 * 8, 32, 1024, 512)
# opt_ragged (bf16 compute, bf16 gossip payload, the ragged MoE) against the f32
# ragged run from the same init and tokens: round 1's loss within this much of
# it. bf16 keeps 8 significant bits (a rounding moves a value by up to 2^-9 =
# 2.0e-3 of it); the loss averages 2,048 tokens' cross-entropies whose logits
# pass 24 layers of bf16 products, so rounding shifts it by a few of those
# units at most, while a wrong grouped product moves the logits by O(1)
OPT_RAGGED_LOSS_RTOL = 1e-2
# the AdamW kernel (row 8) at one vehicle step's leaves of cells 6 and 2: (label,
# architecture, layers (None: all), held routed experts (None: all))
ADAMW_CELLS = (("moonlight_cell6", "moonlight-16b-a3b", 7, 8),
               ("granite_cell2", "granite-moe-1b-a400m", None, None))

# the cost-model phase: the reference's scale workload (BENCH_scale.json,
# benchmarks/engine_scale.py) at K=1024, 2 timed epochs after a 1-epoch warm-up,
# on 8,192 synthetic MNIST training samples
SCALE_K, SCALE_EPOCHS, SCALE_N_TRAIN = 1024, 2, 8192
SRC = Path(__file__).resolve().parent / "src"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


# ------------------------------------------------------------------ timing ----

def _hold_device(ms: float = 8.0) -> None:
    """Keep the device busy for a few ms so that the launches timed next are
    all queued before the first of them runs: the events then bracket device
    time, not the host's launch rate."""
    torch.cuda._sleep(int(ms * 1.5e6))


def time_ms(fn, inner: int = 10, reps: int = 15, warm: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of one call of ``fn``,
    each rep averaging ``inner`` back-to-back calls (inputs warm in L2, as
    the round finds the parameters it has just updated)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _hold_device()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


# ----------------------------------------------------------- kernel checks ----

def _dense_case(k_out, k_in, p, dtype, seed, device):
    r = np.random.default_rng(seed)
    w = torch.as_tensor(r.dirichlet(np.ones(k_in), size=k_out).astype(np.float32))
    x = torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype)
    return w.to(device), x.to(device)


def _sparse_case(k_out, k_in, d, p, dtype, seed, device):
    r = np.random.default_rng(seed)
    idx = torch.as_tensor(r.integers(0, k_in, size=(k_out, d)).astype(np.int32))
    w = r.random((k_out, d)).astype(np.float32)
    w[:, -1] = 0.0                                  # a zero-weight padding slot
    x = torch.as_tensor(r.normal(size=(k_in, p)).astype(np.float32)).to(dtype)
    return idx.to(device), torch.as_tensor(w).to(device), x.to(device)


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


PATHS = {kernel.MATMUL_TILES: "tiles", kernel.MATMUL_COLUMNS: "columns"}


def _in_place_matches(w, flats, outs) -> bool:
    """``flats`` mixed in place (on copies) equal ``outs`` bit for bit, and
    every copy keeps its address."""
    copies = [x.clone() for x in flats]
    ptrs = [x.data_ptr() for x in copies]
    got = kernel.gossip_mix_matmul_grouped(w, copies, out=copies)
    torch.cuda.synchronize()
    return all(g is c and c.data_ptr() == ptr and torch.equal(c, o)
               for g, c, ptr, o in zip(got, copies, ptrs, outs))


def _refused(fn, what: str) -> None:
    try:
        fn()
    except ValueError as e:
        log(f"  ok: refused {what} ({e})")
        return
    raise SystemExit(f"FAILED: gossip_mix_matmul took {what}")


def check_small_k_cases(device) -> float:
    """The column mapping beyond square W: S=3 seeds at K=4, rectangular
    ``[4, 100]`` and ``[8, 2]`` Ws (a per-shard block of K=8 over N=4 ranks),
    an unaligned leaf view, each against the plain version and in place
    where the launcher takes it; then the refusals, by the wrapper and by the
    C launcher called with the same pointers. Returns the largest error."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    r = np.random.default_rng(17)
    for what, seeds, k_out, k_in, dtype in (("S=3 seeds", 3, 4, 4, f32),
                                            ("S=3 seeds", 3, 4, 4, bf16),
                                            ("rectangular", None, 4, 100, f32),
                                            ("per-shard block", None, 8, 2, f32)):
        lead = () if seeds is None else (seeds,)
        w = torch.as_tensor(r.dirichlet(np.ones(k_in), size=lead + (k_out,))
                            .astype(np.float32)).to(device)
        flats = [torch.as_tensor(r.normal(size=lead + (k_in, p)).astype(np.float32))
                 .to(device).to(dtype) for p in TRAIN_SMALL_WIDTHS]
        outs = kernel.gossip_mix_matmul_grouped(w, flats)
        torch.cuda.synchronize()
        err = max(_max_err(o, ref.gossip_mix_matmul_ref(w, x)) for o, x in zip(outs, flats))
        path = kernel.matmul_path(k_out, k_in)
        in_place = k_out == k_in and _in_place_matches(w, flats, outs)
        check(err <= ATOL[dtype] and path == kernel.MATMUL_COLUMNS
              and (in_place or k_out != k_in),
              f"gossip_mix_matmul {what}: W {list(w.shape)}, path {PATHS[path]}, {dtype}, "
              f"max err {err:.2e}" + (", in place bit for bit" if in_place else ""))
        worst = max(worst, err)
    w, x = _dense_case(3, 3, 64, f32, 3, device)
    shifted = torch.zeros(3 * 64 + 1, device=device)[1:].view(3, 64).copy_(x)
    out = kernel.gossip_mix_matmul(w, shifted)
    err = _max_err(out, ref.gossip_mix_matmul_ref(w, x))
    kernel.gossip_mix_matmul_grouped(w, [shifted], out=[shifted])
    torch.cuda.synchronize()
    check(err <= 1e-5 and torch.equal(shifted, out),
          f"gossip_mix_matmul on a leaf 4 bytes off a 16-byte boundary (element-wise "
          f"path): max err {err:.2e}, in place bit for bit")
    worst = max(worst, err)
    # refusals: in place on a rectangular W, above the column mapping's limit, a
    # partial overlap, an output on another leaf's input, overlapping outputs
    w4, flats4 = _dense_case(4, 100, 256, f32, 4, device)
    w_tile, x_tile = _dense_case(100, 100, 256, f32, 5, device)
    w2, _ = _dense_case(2, 2, 1, f32, 6, device)
    a, b = (_dense_case(2, 2, 256, f32, s, device)[1] for s in (7, 8))
    buf = torch.zeros(2 * 256 + 4, device=device)
    cases = (("in place on a rectangular [4, 100] W", w4, [flats4], [flats4[:4]]),
             ("in place at K_out=100 (tiles)", w_tile, [x_tile], [x_tile]),
             ("a partial overlap", w2, [buf[:512].view(2, 256)], [buf[4:516].view(2, 256)]),
             ("an output on another leaf's input", w2, [a, b], [b, torch.empty_like(a)]),
             ("two overlapping outputs", w2, [a, b],
              [buf[:512].view(2, 256), buf[4:516].view(2, 256)]))
    launch = kernel._LIBS["gossip_mix_matmul"].gossip_mix_matmul_grouped_launch
    for what, w, ins, outs in cases:
        _refused(lambda: kernel.gossip_mix_matmul_grouped(w, ins, out=outs), what)
        n = len(ins)
        code = launch(w.data_ptr(), (ctypes.c_void_p * n)(*(t.data_ptr() for t in ins)),
                      (ctypes.c_void_p * n)(*(t.data_ptr() for t in outs)),
                      (ctypes.c_longlong * n)(*(t.shape[1] for t in ins)), n, 1,
                      w.shape[0], w.shape[1], 0, torch.cuda.current_stream().cuda_stream)
        check(code == 1, f"the C launcher refuses {what} (cudaErrorInvalidValue, got {code})")
    _refused(lambda: ops.mix_params_cuda_(w_tile, {"a": x_tile}), "mix_params_cuda_ at K=100")
    for k_out, k_in in ((100, 100), (100, 50), (100, 25)):
        check(kernel.matmul_path(k_out, k_in) == kernel.MATMUL_TILES,
              f"W [{k_out}, {k_in}] (rows 2, 2s, 2r) keeps the tile mapping")
    return worst


def check_kernels(device, k: int, d_max: int) -> dict[str, float]:
    """Both gossip-mix kernels against their plain versions on the card, one
    leaf at a time and in groups (one launch per group, leaf by leaf).
    Returns the largest absolute error seen per kernel; fails past the
    tolerance."""
    f32, bf16 = torch.float32, torch.bfloat16
    sweep = [(7, 7, 33, f32), (16, 16, 512, f32), (64, 64, 2048, f32),
             (100, 100, 700, f32), (12, 12, 257, bf16), (8, 8, 128, bf16),
             (3, 8, 130, f32), (8, 4, 257, f32),          # rectangular
             (5, 11, 136, bf16), (33, 240, 1000, f32)]    # ... and a wide W
    main = [(k, k, p, f32) for p in LEAF_WIDTHS + [sum(LEAF_WIDTHS)]]
    main += [(k, k, sum(LEAF_WIDTHS), bf16)]
    worst = {"gossip_mix_gather": 0.0, "gossip_mix_matmul": 0.0}
    for k_out, k_in, p, dtype in sweep + main:
        w, x = _dense_case(k_out, k_in, p, dtype, k_out * 1000 + p, device)
        got = kernel.gossip_mix_matmul(w, x)
        torch.cuda.synchronize()
        err = _max_err(got, ref.gossip_mix_matmul_ref(w, x))
        check(got.shape == (k_out, p) and got.dtype == dtype and err <= ATOL[dtype],
              f"gossip_mix_matmul [{k_out},{k_in}]x[{k_in},{p}] {dtype} max err {err:.2e}")
        worst["gossip_mix_matmul"] = max(worst["gossip_mix_matmul"], err)
    sparse_sweep = [(k_out, k_in, 5, p, dt) for k_out, k_in, p, dt in sweep]
    sparse_sweep.append((8, 8, 5, 260, f32))
    sparse_main = [(k, k, d_max, p, dt) for _, _, p, dt in main]
    for k_out, k_in, d, p, dtype in sparse_sweep + sparse_main:
        idx, w, x = _sparse_case(k_out, k_in, d, p, dtype, 9 + k_out + p, device)
        got = kernel.gossip_mix_gather(idx, w, x)
        torch.cuda.synchronize()
        err = _max_err(got, ref.gossip_mix_gather_ref(idx, w, x))
        check(got.shape == (k_out, p) and got.dtype == dtype and err <= ATOL[dtype],
              f"gossip_mix_gather K_out={k_out} K_in={k_in} D={d} P={p} {dtype} "
              f"max err {err:.2e}")
        worst["gossip_mix_gather"] = max(worst["gossip_mix_gather"], err)
    # the grouped launch over the model's leaves (one launch per mix), and
    # over widths of one column, not a multiple of 4, and K_in past one chunk
    for k_out, k_in, widths, dtype in ((k, k, LEAF_WIDTHS, f32), (k, k, LEAF_WIDTHS, bf16),
                                       (33, 300, [1, 7, 250, 4097], f32),
                                       (8, 13, [1, 7, 250, 4097], bf16)):
        w, _ = _dense_case(k_out, k_in, 1, f32, k_out + k_in, device)
        flats = [_dense_case(k_out, k_in, p, dtype, p, device)[1] for p in widths]
        before = kernel.launch_counts["gossip_mix_matmul"]
        outs = kernel.gossip_mix_matmul_grouped(w, flats)
        torch.cuda.synchronize()
        err = max(_max_err(o, ref.gossip_mix_matmul_ref(w, x)) for o, x in zip(outs, flats))
        check(kernel.launch_counts["gossip_mix_matmul"] == before + 1 and err <= ATOL[dtype],
              f"gossip_mix_matmul grouped: one launch over {len(widths)} leaves {widths}, "
              f"W [{k_out},{k_in}], {dtype}, max err {err:.2e}")
        worst["gossip_mix_matmul"] = max(worst["gossip_mix_matmul"], err)
    # few rows (the train round's vehicles, small federations): K = 1-17 on both
    # sides of the column mapping's limit, over leaf widths that are not
    # multiples of 64; in place (where the launcher takes it) against out of place
    for kv in TRAIN_SMALL_K:
        path = kernel.matmul_path(kv, kv)
        for dtype in (f32, bf16):
            w, _ = _dense_case(kv, kv, 1, f32, 50 + kv, device)
            flats = [_dense_case(kv, kv, p, dtype, p + kv, device)[1] for p in TRAIN_SMALL_WIDTHS]
            before = kernel.launch_counts["gossip_mix_matmul"]
            outs = kernel.gossip_mix_matmul_grouped(w, flats)
            torch.cuda.synchronize()
            err = max(_max_err(o, ref.gossip_mix_matmul_ref(w, x)) for o, x in zip(outs, flats))
            check(kernel.launch_counts["gossip_mix_matmul"] == before + 1 and err <= ATOL[dtype]
                  and all(o.shape == x.shape for o, x in zip(outs, flats)),
                  f"gossip_mix_matmul grouped at K={kv} (path {PATHS[path]}): one launch over "
                  f"widths {TRAIN_SMALL_WIDTHS}, {dtype}, max err {err:.2e}")
            worst["gossip_mix_matmul"] = max(worst["gossip_mix_matmul"], err)
            if path == kernel.MATMUL_COLUMNS:
                same = _in_place_matches(w, flats, outs)
                check(same, f"gossip_mix_matmul in place at K={kv}, {dtype}: equal to out of "
                      "place bit for bit, every leaf at its address")
            else:
                _refused(lambda: kernel.gossip_mix_matmul_grouped(w, flats, out=flats),
                         f"in place at K={kv} under the {PATHS[path]} mapping")
    worst["gossip_mix_matmul"] = max(worst["gossip_mix_matmul"], check_small_k_cases(device))
    # an unaligned view start forces the element-wise instantiation
    idx, w, x = _sparse_case(9, 9, 4, 64, f32, 1, device)
    base = torch.zeros(9 * 64 + 1, device=device)
    shifted = base[1:].view(9, 64)
    shifted.copy_(x)
    err = _max_err(kernel.gossip_mix_gather(idx, w, shifted),
                   ref.gossip_mix_gather_ref(idx, w, x))
    check(err <= 1e-5, f"gossip_mix_gather on a 4-byte-aligned X max err {err:.2e}")
    worst["gossip_mix_gather"] = max(worst["gossip_mix_gather"], err)
    # the grouped gather: the model's leaves (f32, bf16), mixed widths with a
    # 4-byte-aligned leaf among 16-byte ones, rectangular lists, and a group
    # past the leaf table (two launches)
    table = kernel.gather_max_leaves()
    # (K_out, K_in, D, widths, dtype, last leaf 4 bytes off a 16-byte boundary)
    groups = [(k, k, d_max, LEAF_WIDTHS, f32, False), (k, k, d_max, LEAF_WIDTHS, bf16, False),
              (33, 300, 9, [1, 7, 250, 4097, 64], f32, True),
              (8, 13, 4, [1, 7, 250, 4097], bf16, False),
              (9, 9, 4, [1 + 37 * i for i in range(table + 6)], f32, False)]
    for k_out, k_in, d, widths, dtype, shift_last in groups:
        g_idx, g_w, _ = _sparse_case(k_out, k_in, d, 1, f32, k_out + k_in, device)
        flats = [_sparse_case(k_out, k_in, d, p, dtype, p, device)[2] for p in widths]
        if shift_last:
            view = torch.zeros(k_in * widths[-1] + 1, dtype=dtype, device=device)[1:]
            flats[-1] = view.view(k_in, widths[-1]).copy_(flats[-1])
        before = kernel.launch_counts["gossip_mix_gather"]
        outs = kernel.gossip_mix_gather_grouped(g_idx, g_w, flats)
        torch.cuda.synchronize()
        launches = kernel.launch_counts["gossip_mix_gather"] - before
        err = max(_max_err(o, ref.gossip_mix_gather_ref(g_idx, g_w, x))
                  for o, x in zip(outs, flats))
        want = -(-len(widths) // table)
        check(launches == want and err <= ATOL[dtype]
              and all(o.shape == (k_out, x.shape[1]) for o, x in zip(outs, flats)),
              f"gossip_mix_gather grouped: {launches} launch(es) over {len(widths)} leaves "
              f"(table of {table}), K_out={k_out} K_in={k_in} D={d}, {dtype}, "
              f"max err {err:.2e}")
        worst["gossip_mix_gather"] = max(worst["gossip_mix_gather"], err)
    # what the wrappers must refuse
    for bad in (lambda: kernel.gossip_mix_matmul(w, x),                     # shapes
                lambda: kernel.gossip_mix_matmul(torch.eye(9, device=device), x.double()),
                lambda: kernel.gossip_mix_gather(idx.long(), w, x),
                lambda: kernel.gossip_mix_gather(idx, w, x.t()),
                lambda: kernel.gossip_mix_matmul(w.cpu(), x),                 # devices
                lambda: kernel.gossip_mix_matmul_grouped(                      # one dtype
                    torch.eye(9, device=device), [x, x.to(bf16)]),
                lambda: kernel.gossip_mix_gather_grouped(idx, w, [x, x.to(bf16)]),
                lambda: kernel.gossip_mix_gather_grouped(                      # one K_in
                    idx, w, [x, torch.ones(5, 64, device=device)]),
                lambda: kernel.gossip_mix_gather_grouped(idx, w, [x, x.cpu()]),
                lambda: kernel.gossip_mix_gather_grouped(idx, w, [x, x.t()])):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAILED: a wrapper accepted an input its kernel does not take")
    try:                                # D past the block's slot buffer: refused in C
        kernel.gossip_mix_gather(torch.zeros(4, 2000, dtype=torch.int32, device=device),
                                 torch.zeros(4, 2000, device=device), x)
        raise SystemExit("FAILED: gossip_mix_gather took D = 2000 slots")
    except RuntimeError:
        pass
    log("  ok: wrappers raise on wrong shape / dtype / layout / device / mixed dtypes / "
        "mixed K_in / D past the slot buffer")
    return worst


def seed_mixings(full: SimulationConfig, device):
    """The first epoch's uniform mixing of each seed of ``SEEDS`` at the main
    path's configuration, stacked on the seed axis: a ``SparseMixing`` ``[S,
    K, D]`` (the widest seed's D) and the same weights dense, ``[S, K, K]``."""
    windows = []
    for seed in SEEDS:
        cfg = replace(full, seed=seed)
        net = topology.make_road_network(cfg.road_net, seed=seed)
        windows.append(engine.ContactStream(cfg, net).window(1))
    stacked = contacts_lib.to_device(contacts_lib.stack_windows(windows), device)
    sparse = aggregation.uniform_mixing(contacts_lib.epoch_of(stacked, 0, axis=1))
    dense = torch.stack([
        torch.as_tensor(contacts_lib.mixing_to_dense(contacts_lib.SparseMixing(i, w)))
        for i, w in zip(sparse.idx, sparse.w)]).to(device)
    return sparse, dense


def check_seed_kernels(device, mixing_sparse, mixing_dense) -> dict[str, float]:
    """Both mixes with the seed axis against their plain versions on the
    card: S seeds of the model's 8 leaves in ONE launch, f32 and bf16, on
    the seeds' mixing and on its neighbour-only part (delayed gossip: zero
    diagonal, rows summing to less than one, and one vehicle of seed 0 that
    met no one — an all-zero row, whose output must be exactly 0). Returns
    the largest absolute error per kernel; fails past the tolerance."""
    f32, bf16 = torch.float32, torch.bfloat16
    seeds, k = mixing_dense.shape[:2]
    nbr_dense = vehicle_axis.zero_self_weight(mixing_dense).clone()
    nbr_dense[0, 0] = 0.0
    nbr = vehicle_axis.zero_self_weight(mixing_sparse)
    nbr_w = nbr.w.clone()
    nbr_w[0, 0] = 0.0
    nbr_sparse = contacts_lib.SparseMixing(nbr.idx, nbr_w)
    sums = nbr_dense.sum(-1)
    check(bool((sums < 1.0).all()) and float(sums[0, 0]) == 0.0
          and _max_err(torch.as_tensor(contacts_lib.mixing_to_dense(
              contacts_lib.SparseMixing(nbr_sparse.idx[1], nbr_sparse.w[1]))),
              nbr_dense[1].cpu()) <= 1e-7,
          "delayed-gossip mixing: zero diagonal, every row sums below 1, row 0 of "
          "seed 0 all zeros, the two formats agree")
    worst = {"gossip_mix_gather": 0.0, "gossip_mix_matmul": 0.0}
    r = np.random.default_rng(5)
    for dtype in (f32, bf16):
        leaves = [torch.as_tensor(r.normal(size=(seeds, k, p)).astype(np.float32))
                  .to(device).to(dtype) for p in LEAF_WIDTHS]
        for what, dense, sparse in (("sync", mixing_dense, mixing_sparse),
                                    ("neighbour-only", nbr_dense, nbr_sparse)):
            idx = sparse.idx.to(torch.int32).contiguous()
            w = sparse.w.contiguous()
            for name, launch, plain in (
                    ("gossip_mix_matmul",
                     lambda: kernel.gossip_mix_matmul_grouped(dense, leaves),
                     lambda x: ref.gossip_mix_matmul_ref(dense, x)),
                    ("gossip_mix_gather",
                     lambda: kernel.gossip_mix_gather_grouped(idx, w, leaves),
                     lambda x: ref.gossip_mix_gather_ref(idx, w, x))):
                before = kernel.launch_counts[name]
                outs = launch()
                torch.cuda.synchronize()
                launches = kernel.launch_counts[name] - before
                err = max(_max_err(o, plain(x)) for o, x in zip(outs, leaves))
                zero_row = what == "sync" or all(
                    float(o[0, 0].float().abs().max()) == 0.0 for o in outs)
                check(launches == 1 and err <= ATOL[dtype] and zero_row
                      and all(o.shape == x.shape and o.dtype == dtype
                              for o, x in zip(outs, leaves)),
                      f"{name} seed axis, {what} mixing: 1 launch over S={seeds} seeds x "
                      f"{len(leaves)} leaves, K={k}, {dtype}, max err {err:.2e}")
                worst[name] = max(worst[name], err)
    x = torch.zeros(seeds, k, 8, device=device)
    for bad in (lambda: kernel.gossip_mix_matmul_grouped(mixing_dense[:2], [x]),   # S
                lambda: kernel.gossip_mix_gather_grouped(
                    mixing_sparse.idx[:2].int().contiguous(),
                    mixing_sparse.w[:2].contiguous(), [x]),
                lambda: kernel.gossip_mix_matmul_grouped(mixing_dense, [x[0]])):  # rank
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAILED: a seed-axis wrapper accepted an input its kernel "
                         "does not take")
    log("  ok: seed-axis wrappers raise on a seed count or rank that does not match")
    return worst


def _timed(fn, plain, library, nbytes: int, flops: int, work: str,
           flop_rate: float = hw.F32_FLOP_PER_S, **time_kw) -> dict:
    """The timing keys of one kernels-line row: the kernel and its plain
    version in turns (plain, kernel, kernel, plain, within this call), the
    library call where there is one, and the bound — the larger of the bytes
    the function must move over the memory rate and its operations over the
    rate of their type (f32 unless ``flop_rate`` says otherwise).
    ``time_kw`` goes to ``time_ms``."""
    t_bytes = nbytes / hw.HBM_BYTES_PER_S * 1e3
    t_flops = flops / flop_rate * 1e3
    plain_a = time_ms(plain, **time_kw)
    ms_a = time_ms(fn, **time_kw)
    ms_b = time_ms(fn, **time_kw)
    plain_b = time_ms(plain, **time_kw)
    return {"ms": min(ms_a, ms_b), "plain_ms": min(plain_a, plain_b),
            "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "library_ms": None if library is None else time_ms(library, **time_kw),
            "work": work, "ms_repeat": [ms_a, ms_b], "plain_ms_repeat": [plain_a, plain_b]}


def time_kernels(device, mixing_sparse, mixing_dense) -> dict[str, dict]:
    """Times at the main path's shapes: one round's mix is one grouped launch
    over the model's 8 leaves, gather or matmul. Also one launch over the
    whole flattened model, for scale. Returns the timing keys of the kernels
    line."""
    k = mixing_dense.shape[0]
    r = np.random.default_rng(0)
    leaves = [torch.as_tensor(r.normal(size=(k, p)).astype(np.float32)).to(device)
              for p in LEAF_WIDTHS]
    whole = torch.cat(leaves, dim=1).contiguous()
    idx = mixing_sparse.idx.to(torch.int32).contiguous()
    w = mixing_sparse.w.contiguous()
    nnz = int((w != 0).sum())
    d = idx.shape[1]
    csr = torch.as_tensor(contacts_lib.mixing_to_dense(mixing_sparse)).to(device).to_sparse_csr()
    esize = 4
    out = {}

    def per_leaf(fn):
        return lambda: [fn(x) for x in leaves]

    # bytes: every input read once, every output written once, per launch
    model_bytes = sum(2 * k * p * esize for p in LEAF_WIDTHS)
    gather_bytes = model_bytes + k * d * 8
    gather_flops = 2 * nnz * sum(LEAF_WIDTHS)        # real slots only
    matmul_bytes = model_bytes + k * k * 4
    matmul_flops = 2 * k * k * sum(LEAF_WIDTHS)
    specs = {
        "gossip_mix_gather": dict(
            round=lambda: kernel.gossip_mix_gather_grouped(idx, w, leaves),
            one=lambda x: kernel.gossip_mix_gather(idx, w, x),
            plain=lambda x: ref.gossip_mix_gather_ref(idx, w, x),
            library=lambda x: torch.sparse.mm(csr, x),
            bytes=gather_bytes, flops=gather_flops,
            work=f"one round's mix: 1 grouped launch over {len(leaves)} leaves, K={k}, "
                 f"leaf widths {LEAF_WIDTHS}, D={d}, {nnz} real slots; library_ms: "
                 f"{len(leaves)} torch.sparse.mm calls (CSR), whole_model_library_ms: one "
                 "over the concatenated model"),
        "gossip_mix_matmul": dict(
            round=lambda: kernel.gossip_mix_matmul_grouped(mixing_dense, leaves),
            one=lambda x: kernel.gossip_mix_matmul(mixing_dense, x),
            plain=lambda x: ref.gossip_mix_matmul_ref(mixing_dense, x),
            library=lambda x: torch.matmul(mixing_dense, x),
            bytes=matmul_bytes, flops=matmul_flops,
            work=f"one round's mix: 1 grouped launch over {len(leaves)} leaves, K={k}, "
                 f"leaf widths {LEAF_WIDTHS}; library_ms: {len(leaves)} torch.matmul calls, "
                 "whole_model_library_ms: one over the concatenated model"),
    }
    for name, s in specs.items():
        out[name] = _timed(s["round"], per_leaf(s["plain"]), per_leaf(s["library"]),
                           s["bytes"], s["flops"], s["work"])
        t_flops = s["flops"] / hw.F32_FLOP_PER_S * 1e3
        out[name].update({
            "whole_model_ms": time_ms(lambda: s["one"](whole)),
            "whole_model_plain_ms": time_ms(lambda: s["plain"](whole)),
            "whole_model_library_ms": time_ms(lambda: s["library"](whole)),
            "whole_model_bound_ms": max(
                (2 * k * whole.shape[1] * esize
                 + (k * d * 8 if name.endswith("gather") else k * k * 4))
                / hw.HBM_BYTES_PER_S * 1e3, t_flops),
        })
        log(f"  {name}: {json.dumps(out[name])}")
    return out


def time_matmul_crossover(device) -> dict:
    """Where ``gossip_mix_matmul``'s two mappings cross, per K and dtype, on
    the MNIST CNN's 8 leaves (21,840 columns, L2-warm: the federation's round)
    and on 4 leaves of 2^23 columns (past the L2: the train round's regime):
    the launcher's own mapping (columns at K <= its limit) against the tile
    mapping, reached through the same launcher by padding W with zero rows up
    to the smallest K_out the tiles take. The padded launch also writes those
    rows, so its time is an upper bound on the tiles' time at K. Square W, in
    turns (tiles, columns, columns, tiles), each beside its bound; the
    padded rows' first K against the columns' output (f32 1e-5, bf16 5e-2).
    Logs one line per case; returns, per shape and dtype, the K at which the
    padded tiles win."""
    tiles_k = next(k for k in range(1, 129) if kernel.matmul_path(k, 1) == kernel.MATMUL_TILES)
    gen = torch.Generator(device=device).manual_seed(21)
    wins = {}
    for shape, widths, ks, time_kw in (
            ("cnn_round", LEAF_WIDTHS, range(1, tiles_k), dict(inner=10, reps=7, warm=3)),
            ("wide", [1 << 23] * 4, (1, 2, 4, 8, 9, 16), dict(inner=1, reps=5, warm=1))):
        for dtype in (torch.float32, torch.bfloat16):
            esize, cols = torch.tensor([], dtype=dtype).element_size(), sum(widths)
            wins[f"{shape}/{str(dtype).split('.')[-1]}"] = won = []
            for k in ks:
                w = torch.as_tensor(np.random.default_rng(k).dirichlet(np.ones(k), size=k)
                                    .astype(np.float32)).to(device)
                padded = torch.cat([w, torch.zeros(tiles_k - k, k, device=device)])
                flats = [torch.randn(k, p, device=device, generator=gen).to(dtype)
                         for p in widths]
                err = max(_max_err(t[:k], c) for t, c in zip(
                    kernel.gossip_mix_matmul_grouped(padded, flats),
                    kernel.gossip_mix_matmul_grouped(w, flats)))
                check(err <= ATOL[dtype], f"gossip_mix_matmul crossover {shape} K={k} {dtype}: "
                      f"tiles (W padded to {tiles_k} rows) vs the launcher's mapping, "
                      f"max diff {err:.2e}")
                tiles = lambda: kernel.gossip_mix_matmul_grouped(padded, flats)  # noqa: E731
                own = lambda: kernel.gossip_mix_matmul_grouped(w, flats)  # noqa: E731
                t_a, c_a, c_b, t_b = (time_ms(fn, **time_kw) for fn in (tiles, own, own, tiles))
                bound = max((2 * k * cols * esize + k * k * 4) / hw.HBM_BYTES_PER_S,
                            2 * k * k * cols / hw.F32_FLOP_PER_S) * 1e3
                row = {"shape": shape, "dtype": str(dtype).split(".")[-1], "K": k,
                       "columns": cols, "path": PATHS[kernel.matmul_path(k, k)],
                       "own_ms": min(c_a, c_b), "tiles_padded_ms": min(t_a, t_b),
                       "own_ms_repeat": [c_a, c_b], "tiles_padded_ms_repeat": [t_a, t_b],
                       "bound_ms": bound, "own_share_of_bound": bound / min(c_a, c_b)}
                if row["tiles_padded_ms"] < row["own_ms"]:
                    won.append(k)
                log(f"  crossover: {json.dumps(row)}")
                del flats
    log(f"  crossover: K at which the tiles (padded to {tiles_k} rows) beat the launcher's "
        f"mapping, per shape/dtype: {json.dumps(wins)}")
    return wins


def _shard_blocks(mixing_sparse, mixing_dense, n: int, rank: int):
    """Rank ``rank`` of ``n``'s part of a round's mixing, as the sharded mix
    hands it to the kernels: the ``[K, K/n]`` column block of W, and the
    ``[K, D]`` neighbour list remapped into ``[0, K/n)`` with the other
    ranks' sources clipped and weighted 0."""
    k = mixing_dense.shape[0]
    k_local = k // n
    start = rank * k_local
    block = vehicle_axis.local_mixing(mixing_dense, start, k_local).contiguous()
    local = vehicle_axis.local_mixing(mixing_sparse, start, k_local)
    return (start, k_local, block, local.idx.to(torch.int32).contiguous(),
            local.w.contiguous())


def check_shard_kernels(device, mixing_sparse, mixing_dense) -> dict[str, float]:
    """Both mixes at the sharded path's shapes: every rank's block of the
    main path's first mixing at N = 2 and 4 (W ``[100, 50]`` / ``[100, 25]``,
    ids clipped into ``[0, 50)`` / ``[0, 25)``) over that rank's rows of the
    model's 8 leaves, one grouped launch each, f32 and bf16, against the
    plain versions; the N partial mixes of f32 leaves sum to the global mix.
    Returns the largest absolute error per kernel."""
    k = mixing_dense.shape[0]
    r = np.random.default_rng(21)
    worst = {"gossip_mix_gather": 0.0, "gossip_mix_matmul": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [torch.as_tensor(r.normal(size=(k, p)).astype(np.float32)).to(device)
                  .to(dtype) for p in LEAF_WIDTHS]
        for n in SHARD_COUNTS:
            sums = {name: [torch.zeros(k, p, device=device) for p in LEAF_WIDTHS]
                    for name in worst}
            clipped = 0
            for rank in range(n):
                start, k_local, block, idx, w = _shard_blocks(mixing_sparse, mixing_dense,
                                                              n, rank)
                clipped += int((w == 0).sum() - (mixing_sparse.w == 0).sum())
                local = [x[start:start + k_local] for x in leaves]
                for name, launch, plain in (
                        ("gossip_mix_matmul",
                         lambda: kernel.gossip_mix_matmul_grouped(block, local),
                         lambda x: ref.gossip_mix_matmul_ref(block, x)),
                        ("gossip_mix_gather",
                         lambda: kernel.gossip_mix_gather_grouped(idx, w, local),
                         lambda x: ref.gossip_mix_gather_ref(idx, w, x))):
                    before = kernel.launch_counts[name]
                    outs = launch()
                    torch.cuda.synchronize()
                    err = max(_max_err(o, plain(x)) for o, x in zip(outs, local))
                    check(kernel.launch_counts[name] == before + 1 and err <= ATOL[dtype]
                          and all(o.shape == (k, x.shape[1]) for o, x in zip(outs, local)),
                          f"{name} rank {rank} of {n}: 1 launch over {len(local)} leaves "
                          f"[{k_local}, P], {'W' if 'matmul' in name else 'ids'} "
                          f"[{k}, {k_local if 'matmul' in name else idx.shape[1]}], "
                          f"{dtype}, max err {err:.2e}")
                    worst[name] = max(worst[name], err)
                    sums[name] = [t + o.float() for t, o in zip(sums[name], outs)]
            if dtype != torch.float32:
                continue
            check(clipped > 0, f"N={n}: {clipped} neighbour slots of other ranks clipped "
                  "and weighted 0")
            for name, plain in (("gossip_mix_matmul",
                                 lambda x: ref.gossip_mix_matmul_ref(mixing_dense, x)),
                                ("gossip_mix_gather",
                                 lambda x: ref.gossip_mix_gather_ref(
                                     mixing_sparse.idx.to(torch.int32), mixing_sparse.w, x))):
                err = max(_max_err(t, plain(x)) for t, x in zip(sums[name], leaves))
                check(err <= ATOL[dtype], f"{name}: the {n} ranks' partial mixes sum to "
                      f"the global mix, max err {err:.2e}")
    return worst


def time_shard_kernels(device, mixing_sparse, mixing_dense) -> dict[str, dict]:
    """Times of one rank's partial mix, one grouped launch over the model's
    8 leaves (rank 0's block of the main path's first mixing): at N=2 in
    the row's keys, at N=4 under ``n4``. Bounds count this rank's work: its
    ``[K/N, P]`` leaves read once, the ``[K, P]`` partial sums written once,
    its W block or neighbour list read once; the gather's operations are
    those of the slots it owns."""
    k = mixing_dense.shape[0]
    r = np.random.default_rng(2)
    out = {}
    for n in SHARD_COUNTS:
        start, k_local, block, idx, w = _shard_blocks(mixing_sparse, mixing_dense, n, 0)
        leaves = [torch.as_tensor(r.normal(size=(k_local, p)).astype(np.float32)).to(device)
                  for p in LEAF_WIDTHS]
        nnz = int((w != 0).sum())
        csr = torch.as_tensor(contacts_lib.mixing_to_dense(
            contacts_lib.SparseMixing(idx, w), num_cols=k_local)).to(device).to_sparse_csr()
        leaf_bytes = sum((k_local + k) * p * 4 for p in LEAF_WIDTHS)
        specs = {
            "gossip_mix_gather": dict(
                round=lambda: kernel.gossip_mix_gather_grouped(idx, w, leaves),
                plain=lambda: [ref.gossip_mix_gather_ref(idx, w, x) for x in leaves],
                library=lambda: [torch.sparse.mm(csr, x) for x in leaves],
                bytes=leaf_bytes + k * idx.shape[1] * 8, flops=2 * nnz * sum(LEAF_WIDTHS),
                work=f"one rank's partial mix at N={n}: 1 grouped launch over "
                     f"{len(leaves)} leaves [{k_local}, P], ids [{k}, {idx.shape[1]}] "
                     f"remapped into [0, {k_local}), {nnz} owned slots; library_ms: "
                     f"{len(leaves)} torch.sparse.mm calls (CSR [{k}, {k_local}])"),
            "gossip_mix_matmul": dict(
                round=lambda: kernel.gossip_mix_matmul_grouped(block, leaves),
                plain=lambda: [ref.gossip_mix_matmul_ref(block, x) for x in leaves],
                library=lambda: [torch.matmul(block, x) for x in leaves],
                bytes=leaf_bytes + k * k_local * 4,
                flops=2 * k * k_local * sum(LEAF_WIDTHS),
                work=f"one rank's partial mix at N={n}: 1 grouped launch over "
                     f"{len(leaves)} leaves [{k_local}, P], W block [{k}, {k_local}]; "
                     f"library_ms: {len(leaves)} torch.matmul calls"),
        }
        for name, spec in specs.items():
            row = {"ranks": n, **_timed(spec["round"], spec["plain"], spec["library"],
                                        spec["bytes"], spec["flops"], spec["work"])}
            if n == SHARD_COUNTS[0]:
                out[name] = row
            else:
                out[name][f"n{n}"] = row
            log(f"  {name} per-shard block, N={n}: {json.dumps(row)}")
    return out


# the reference's kernel-test shapes (tests/test_kernels.py: V 1-40 x K 2-50,
# and the eg_step cases), then the main path's and the scale sweep's
KL_REF_SHAPES = [(1, 2), (40, 50), (7, 13), (23, 2), (1, 50), (16, 31), (4, 8),
                 (33, 100), (128, 16)]


def _state_case(v, k, dtype, seed, device, rsu_row: bool = False):
    """State vectors on the simplex with a column under the 1e-12 cut, and a
    target. ``rsu_row``: the last participant is a data-less relay — a zero
    target entry, a zero column, and (before it met anyone) a zero row."""
    r = np.random.default_rng(seed)
    s = r.dirichlet(np.ones(k), size=v).astype(np.float32)
    s[:, r.integers(0, k)] = 0.0
    g = r.dirichlet(np.ones(k) * 2).astype(np.float32)
    if rsu_row:
        s[:, -1] = 0.0
        s[-1] = 0.0
        g[-1] = 0.0
        g = g / g.sum()
    s = s / np.maximum(s.sum(1, keepdims=True), 1e-12)
    return (torch.as_tensor(s).to(dtype).to(device),
            torch.as_tensor(g.astype(np.float32)).to(device))


def _eg_case(v, k, dtype, seed, device):
    """alpha on the masked simplex, a gradient, a 0/1 mask with at least one
    active lane per row (as tests/test_kernels.py makes them)."""
    r = np.random.default_rng(seed)
    m = (r.random((v, k)) < 0.5).astype(np.float32)
    m[:, 0] = 1.0
    a = r.dirichlet(np.ones(k), size=v).astype(np.float32) * m
    a = a / a.sum(1, keepdims=True)
    g = r.normal(size=(v, k)).astype(np.float32)
    return tuple(torch.as_tensor(x).to(dtype).to(device) for x in (a, g, m))


def _p1_case(v, k, seed, device, empty_row: bool = True):
    """A P1 problem: states [V, K] (a column under the 1e-12 cut), a target,
    a 0/1 contact matrix [V, V] with a self contact on every row but row 1,
    which (with ``empty_row``) has no contact at all."""
    s, g = _state_case(v, k, torch.float32, seed, device)
    r = np.random.default_rng(seed + 1)
    c = np.minimum((r.random((v, v)) < 0.1) + (r.random((v, v)) < 0.1).T + np.eye(v), 1)
    if empty_row:
        c[1] = 0.0
    return s, g, torch.as_tensor(c.astype(np.float32)).to(device)


def _row_edge_cases(device) -> list:
    """(label, states, target, dtype) for the paths of the row kernels' launcher
    beyond the aligned shapes: K off the 16-byte loads (f32 K % 4, bf16 K % 8),
    a row slice ``s[1:]`` of ``[V, 101]`` and a K % 4 == 0 matrix whose base is
    off a 16-byte boundary, V = 4 at K = 65,536 (g staged in chunks), V = K = 1,
    a one-hot row beside an RSU row (all zero, a zero target entry)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dtype in (f32, bf16):
        cases.append((f"[37,203] {dtype} (K off the 16-byte loads)",
                      *_state_case(37, 203, dtype, 203, device), dtype))
        s, g = _state_case(9, 101, dtype, 101, device)
        cases.append((f"s[1:] of [9,101] {dtype} (base off 16 bytes)", s[1:], g, dtype))
        cases.append((f"[4,65536] {dtype} (g staged in chunks)",
                      *_state_case(4, 65536, dtype, 4, device), dtype))
    s, g = _state_case(9, 64, f32, 64, device)
    flat = torch.empty(9 * 64 + 1, device=device)
    flat[1:] = s.reshape(-1)
    cases.append(("[9,64] float32 at a base 4 bytes off 16", flat[1:].view(9, 64), g, f32))
    cases.append(("[1,1] float32", torch.full((1, 1), 0.75, device=device),
                  torch.ones(1, device=device), f32))
    s, g = _state_case(6, 100, f32, 6, device, rsu_row=True)
    s[2] = 0.0
    s[2, 37] = 1.0
    cases.append(("[6,100] float32 with a one-hot and an RSU row", s, g, f32))
    return cases


def check_kl_kernels(device, k: int, p1_steps: int) -> dict[str, float]:
    """The four kl_simplex kernels against their plain versions on the card,
    at the reference's shapes, the main path's K (and K + 1 with an RSU row),
    K = 1024 and K = 4096 and the launcher's other paths (``_row_edge_cases``),
    one launch each; the one-launch P1 solve at K = 8, the main path's K
    and the library's limit, over 1 and ``p1_steps`` steps; the empty-mask
    rule of eg_step and eg_solve; the wrappers' refusals. Returns the largest
    absolute error per kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"eg_step": 0.0, "eg_solve": 0.0, "kl_rows": 0.0, "entropy_rows": 0.0}
    row_cases = [(v, kk, f32, False) for v, kk in KL_REF_SHAPES]
    row_cases += [(k, k, f32, False), (k + 1, k + 1, f32, True)]
    row_cases += [(v, kk, dt, False) for v, kk in ((1024, 1024), (64, 4096)) for dt in (f32, bf16)]
    cases = [(f"[{v},{kk}] {dtype}{' with an RSU row' if rsu else ''}",
              *_state_case(v, kk, dtype, v * 7 + kk, device, rsu), dtype)
             for v, kk, dtype, rsu in row_cases]
    cases += _row_edge_cases(device)
    for what, s, g, dtype in cases:
        before = {n: kl_simplex.kernel.launch_counts[n] for n in ("kl_rows", "entropy_rows")}
        got_kl = kl_simplex.kl_rows_kernel(s, g)
        got_h = kl_simplex.entropy_rows_kernel(s)
        torch.cuda.synchronize()
        once = all(kl_simplex.kernel.launch_counts[n] == before[n] + 1 for n in before)
        err_kl = _max_err(got_kl, kl_simplex.kl_rows_ref(s, g))
        err_h = _max_err(got_h, kl_simplex.entropy_rows_ref(s))
        check(once and got_kl.shape == got_h.shape == s.shape[:1]
              and max(err_kl, err_h) <= ATOL[dtype],
              f"kl_rows / entropy_rows {what}, one launch each: max err "
              f"{err_kl:.2e} / {err_h:.2e}")
        worst["kl_rows"] = max(worst["kl_rows"], err_kl)
        worst["entropy_rows"] = max(worst["entropy_rows"], err_h)
    eg_cases = [(v, kk, f32) for v, kk in KL_REF_SHAPES]
    eg_cases += [(k, k, f32), (k + 1, k + 1, f32), (1024, 1024, f32), (64, 4096, f32),
                 (16, 200, bf16)]
    for v, kk, dtype in eg_cases:
        a, grad, m = _eg_case(v, kk, dtype, v * 13 + kk, device)
        got = kl_simplex.eg_step(a, grad, m, step_size=2.0)
        torch.cuda.synchronize()
        err = _max_err(got, kl_simplex.eg_step_ref(a, grad, m, step_size=2.0))
        check(got.shape == (v, kk) and got.dtype == f32 and err <= ATOL[dtype]
              and bool((got[m == 0] == 0).all()),
              f"eg_step [{v},{kk}] {dtype} max err {err:.2e}, exactly 0 off the mask")
        worst["eg_step"] = max(worst["eg_step"], err)
    # an all-zero mask row gives 0 everywhere (the Pallas kernel's rule; the
    # plain version gives NaN there), in the register and streaming variants
    for kk in (k, 4096):
        a, grad, m = _eg_case(3, kk, f32, kk, device)
        m[1] = 0.0
        got = kl_simplex.eg_step(a, grad, m)
        torch.cuda.synchronize()
        check(bool((got[1] == 0).all()) and bool(torch.isfinite(got).all()),
              f"eg_step K={kk}: a row with an empty mask is all 0")
    # the whole solve in one launch on dense contacts (no id table), up to the
    # library's limit; row 1 of the contacts is empty (0 by the kernel's rule,
    # as eg_solve_rows_ref gives)
    limit = kl_simplex.kernel.eg_solve_max_k()
    for kk in (8, k, limit):
        for steps in (1, p1_steps):
            s, g, c = _p1_case(kk, kk, kk + steps, device)
            before = kl_simplex.kernel.launch_counts["eg_solve"]
            got = kl_simplex.eg_solve_rows(s, None, g, c, num_steps=steps, step_size=2.0)
            torch.cuda.synchronize()
            launches = kl_simplex.kernel.launch_counts["eg_solve"] - before
            err = _max_err(got, kl_simplex.eg_solve_rows_ref(s, None, g, c, num_steps=steps,
                                                             step_size=2.0))
            check(launches == 1 and got.shape == (kk, kk) and err <= ATOL[f32]
                  and bool((got[c == 0] == 0).all()) and bool((got[1] == 0).all()),
                  f"eg_solve V=K={kk}{' (the limit)' if kk == limit else ''}, {steps} steps: "
                  f"one launch, max err {err:.2e}, 0 off the contacts and on the empty row")
            worst["eg_solve"] = max(worst["eg_solve"], err)
    s, g, c = _p1_case(8, 8, 0, device)
    big_s, big_g, big_c = _p1_case(limit + 1, limit + 1, 0, device)
    solve = kl_simplex.eg_solve_rows
    for bad in (lambda: solve(s.to(bf16), None, g, c, num_steps=2),   # dtype
                lambda: solve(s, None, g[:7].contiguous(), c, num_steps=2),
                lambda: solve(s, None, g, torch.ones(8, 9, device=device), num_steps=2),
                lambda: solve(s, None, g.cpu(), c, num_steps=2),
                lambda: solve(s, None, g, c, num_steps=-1),
                lambda: solve(big_s, None, big_g, big_c, num_steps=2)):   # past the limit
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAILED: eg_solve accepted an input its kernel does not take")
    log(f"  ok: eg_solve raises on wrong dtype / shape / device / steps and past its "
        f"limit (V=K={limit + 1})")
    s, g = _state_case(4, 8, f32, 0, device)
    a, grad, m = _eg_case(4, 8, f32, 0, device)
    for bad in (lambda: kl_simplex.kl_rows_kernel(s.double(), g),          # dtype
                lambda: kl_simplex.kl_rows_kernel(s, g[:7].contiguous()),   # shape
                lambda: kl_simplex.kl_rows_kernel(s, g.to(bf16)),
                lambda: kl_simplex.entropy_rows_kernel(s.t()),              # layout
                lambda: kl_simplex.entropy_rows_kernel(s[0]),
                lambda: kl_simplex.eg_step(a, grad, m.to(bf16)),
                lambda: kl_simplex.eg_step(a, grad, m[:, :5].contiguous()),
                lambda: kl_simplex.eg_step(a, grad.cpu(), m)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAILED: a kl_simplex wrapper accepted an input its kernel does not take")
    log("  ok: kl_simplex wrappers raise on wrong shape / dtype / layout / device")
    return worst


def time_kl_kernels(device, k: int, p1_steps: int) -> dict[str, dict]:
    """The kl_simplex kernels at the main path's V = K (one launch each: one
    P1 step, one diagnostic of a state matrix, one whole P1 solve of
    ``p1_steps`` steps) and at K = 1024, the largest K of the scale sweep
    (not the solve: past its limit), each beside its plain version, its
    library call and its bound; the row kernels also with ``floor_ms``, their
    time at V = 1, K = 32. Returns the timing keys of the kernels line."""
    out = {}
    for kk in (k, 1024):
        s, g = _state_case(kk, kk, torch.float32, kk, device)
        a, grad, m = _eg_case(kk, kk, torch.float32, kk, device)
        n = kk * kk
        specs = {
            # bytes: S read once, g once, [V] written; about 5 / 4 / 20 f32
            # operations per element
            "kl_rows": dict(
                fn=lambda: kl_simplex.kl_rows_kernel(s, g),
                plain=lambda: kl_simplex.kl_rows_ref(s, g),
                library=lambda: torch.nn.functional.kl_div(
                    torch.log(g), s, reduction="none").sum(-1) / LN2,
                bytes=4 * (n + 2 * kk), flops=5 * n),
            "entropy_rows": dict(
                fn=lambda: kl_simplex.entropy_rows_kernel(s),
                plain=lambda: kl_simplex.entropy_rows_ref(s),
                library=lambda: torch.special.entr(s).sum(-1) / LN2,
                bytes=4 * (n + kk), flops=4 * n),
            "eg_step": dict(
                fn=lambda: kl_simplex.eg_step(a, grad, m, step_size=2.0),
                plain=lambda: kl_simplex.eg_step_ref(a, grad, m, step_size=2.0),
                library=None, bytes=16 * n, flops=20 * n),
        }
        for name, spec in specs.items():
            row = _timed(spec["fn"], spec["plain"], spec["library"], spec["bytes"],
                         spec["flops"], f"one launch, V=K={kk}, f32")
            if kk == k:
                out[name] = row
            else:
                out[name][f"k{kk}"] = row
    # the launch floor the row kernels' K = 100 times are read against: the
    # same kernel and protocol at V = 1, K = 32
    s, g = _state_case(1, 32, torch.float32, 32, device)
    for name, fn, plain in (
            ("kl_rows", lambda: kl_simplex.kl_rows_kernel(s, g),
             lambda: kl_simplex.kl_rows_ref(s, g)),
            ("entropy_rows", lambda: kl_simplex.entropy_rows_kernel(s),
             lambda: kl_simplex.entropy_rows_ref(s))):
        out[name]["floor_ms"] = _timed(fn, plain, None, 4 * 33, 5 * 32,
                                       "one launch, V=1, K=32, f32")["ms"]
    # the solve: S, g and the mask read once, alpha written once; two
    # [V, V] x [V, K] products of FMAs per step
    s, g, c = _p1_case(k, k, k, device)
    solve = _timed(lambda: kl_simplex.eg_solve_rows(s, None, g, c, num_steps=p1_steps,
                                                    step_size=2.0),
                   lambda: kl_simplex.eg_solve_rows_ref(s, None, g, c, num_steps=p1_steps,
                                                        step_size=2.0),
                   None, 4 * (k * k + k + 2 * k * k), p1_steps * 2 * 2 * k * k * k,
                   f"one P1 solve in one launch: {p1_steps} EG steps, V=K={k}, f32",
                   inner=2, reps=5, warm=2)
    out["eg_solve"] = solve
    out["eg_step"].update({"solve_ms": solve["ms"], "solve_bound_ms": solve["bound_ms"],
                           "solve_work": solve["work"]})
    out["eg_solve"]["id_table"] = time_eg_solve_rows(device, k, p1_steps)
    for name, row in out.items():
        log(f"  {name}: {json.dumps(row)}")
    return out


def _stream_neighbours(k: int, seed: int) -> contacts_lib.SparseContacts:
    """Epoch 0 of a real contact stream at the paper's settings with ``k``
    vehicles over 50 epochs (the benchmark's federation at K = 100), D_max by
    the stream's own probe: numpy ids / mask ``[k, D_max]``."""
    cfg = SimulationConfig(num_vehicles=k, epochs=50, device="cpu", seed=seed)
    window = engine.ContactStream(cfg, topology.make_road_network(cfg.road_net,
                                                                  seed=cfg.seed)).window(1)
    return contacts_lib.SparseContacts(window.idx[0], window.mask[0])


def time_eg_solve_rows(device, k: int, p1_steps: int) -> dict[str, dict]:
    """``eg_solve`` on an id table (``kernel.eg_solve_rows``, the form
    ``core.kl_solver.solve_p1_all`` takes on the card) at the shapes the
    benchmark's cells give it: K = ``k`` neighbour lists of a real contact
    stream (``p1_steps`` steps), 8 such streams on a seed axis (8 K rows), V = 2
    dense (the train cells: identity ids, 100 steps) and neighbour lists at
    K = 1,024 with 24 slots. Each row: one launch, held to its plain version
    (``eg_solve_rows_ref``, atol 1e-5) and timed beside it and its bound: the
    states, ids, masks and targets read once, alpha written once; two
    ``[D] x [D, K]`` products of FMAs a row and step."""
    cases = {}
    one = _stream_neighbours(k, 0)
    cases[f"k{k}_sparse_d{one.idx.shape[1]}"] = (
        _state_case(k, k, torch.float32, 1, device)[0], one.idx, one.mask, p1_steps)
    seeds = contacts_lib.stack_windows([contacts_lib.SparseContacts(w.idx[None], w.mask[None])
                                        for w in (_stream_neighbours(k, s) for s in range(8))])
    cases[f"seeds8_{8 * k}_rows_d{seeds.idx.shape[-1]}"] = (
        torch.stack([_state_case(k, k, torch.float32, 10 + i, device)[0] for i in range(8)]),
        seeds.idx[:, 0], seeds.mask[:, 0], p1_steps)
    cases["v2_dense"] = (_state_case(2, 2, torch.float32, 2, device)[0], None,
                         np.ones((2, 2), np.float32), TRAIN_P1)
    r = np.random.default_rng(3)
    big_idx = np.repeat(np.arange(1024, dtype=np.int32)[:, None], 24, axis=1)
    big_mask = np.zeros((1024, 24), np.float32)
    big_mask[:, 0] = 1.0
    for v in range(1024):
        others = [u for u in r.choice(1024, size=int(r.integers(0, 24)), replace=False)
                  if u != v]
        big_idx[v, 1:1 + len(others)], big_mask[v, 1:1 + len(others)] = others, 1.0
    cases["k1024_sparse_d24"] = (_state_case(1024, 1024, torch.float32, 3, device)[0],
                                 big_idx, big_mask, p1_steps)
    rows = {}
    for label, (states, ids, mask, steps) in cases.items():
        seeded = states.dim() == 3
        kk = states.shape[-1]
        g = torch.stack([_state_case(1, kk, torch.float32, 20 + i, device)[1]
                         for i in range(states.shape[0])]) if seeded else \
            _state_case(1, kk, torch.float32, 20, device)[1]
        ids_t = None if ids is None else torch.as_tensor(np.ascontiguousarray(ids)).to(device)
        mask_t = torch.as_tensor(np.ascontiguousarray(mask)).to(device)
        before = kl_simplex.kernel.launch_counts["eg_solve"]
        got = kl_simplex.eg_solve_rows(states, ids_t, g, mask_t, num_steps=steps)
        torch.cuda.synchronize()
        check(kl_simplex.kernel.launch_counts["eg_solve"] == before + 1,
              f"eg_solve id table {label}: one launch")
        with full_f32_matmul():
            want = kl_simplex.eg_solve_rows_ref(states, ids_t, g, mask_t, num_steps=steps)
        err = _max_err(got, want)
        check(err <= 1e-5 and bool((got[mask_t == 0] == 0).all()),
              f"eg_solve id table {label}: max err {err:.2e} against eg_solve_rows_ref, 0 off "
              "the mask")
        n_rows, d = mask_t.numel() // mask_t.shape[-1], mask_t.shape[-1]
        nbytes = 4 * (states.numel() + g.numel() + 2 * mask_t.numel()
                      + (0 if ids_t is None else ids_t.numel()))
        with full_f32_matmul():
            row = _timed(lambda: kl_simplex.eg_solve_rows(states, ids_t, g, mask_t,
                                                          num_steps=steps),
                         lambda: kl_simplex.eg_solve_rows_ref(states, ids_t, g, mask_t,
                                                              num_steps=steps),
                         None, nbytes, steps * n_rows * 4 * d * kk,
                         f"one P1 solve in one launch on an id table: {steps} EG steps, "
                         f"{n_rows} rows x [{d}, {kk}]", inner=2, reps=5, warm=2)
        rows[label] = {**row, "max_abs_err": err}
    return rows


# ------------------------------------------------------- flash attention ----

def _qkv(b, s, h, kv, hd, dtype, seed, device, t=None):
    r = np.random.default_rng(seed)
    t = s if t is None else t
    shapes = ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd))
    return tuple(torch.as_tensor(r.normal(size=sh).astype(np.float32)).to(dtype).to(device)
                 for sh in shapes)


def _fa_case(q, k, v, what: str, causal=True, window=None, scale=None,
             rtol=None) -> float:
    """With ``rtol``, every element is also held to
    ``FA_ATOL[f32] + rtol * |want|``: a limit that scales with the value."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    err = _max_err(got, want)
    ok = got.shape == q.shape and got.dtype == q.dtype and err <= FA_ATOL[q.dtype]
    what = f"flash_attention {what} max err {err:.2e}"
    if rtol is not None:
        diff = (got.float() - want.float()).abs()
        excess = (diff - rtol * want.float().abs()).max().item()
        ok = ok and excess <= FA_ATOL[torch.float32]
        what += f", max(|diff| - {rtol:g}|want|) {excess:.2e}"
    check(ok, what)
    return err


def check_flash_attention(device) -> dict[str, float]:
    """The flash-attention kernel against its plain version on the card: the
    reference's sweep, the reference's block-shape case (1, 70, 2, 32), S != T,
    inputs read through strides, the serving shapes (causal f32, causal bf16,
    window 512), f32 at scale 0.3 on the GPU test's inputs, the GQA groups,
    the empty-row rule and the wrapper's refusals. At the serving
    shape bf16 is also held to one bf16 rounding step of each value (rtol
    1e-2 > 2**-7), far inside the sweep's 3e-2. Returns the largest absolute
    error per input dtype."""
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {f32: 0.0, bf16: 0.0}

    def seen(q, err):
        worst[q.dtype] = max(worst[q.dtype], err)
    for b, s, h, kv, hd, causal, win, dtype in FA_SWEEP:
        q, k, v = _qkv(b, s, h, kv, hd, dtype, s * h, device)
        seen(q, _fa_case(q, k, v, f"[{b},{s},{h}/{kv},{hd}] causal={causal} "
                                    f"window={win} {dtype}", causal, win))
    q, k, v = _qkv(1, 70, 2, 2, 32, f32, 1, device)
    seen(q, _fa_case(q, k, v, "[1,70,2/2,32]"))
    for s, t, causal, win, hd in ((40, 72, False, None, 64), (72, 40, False, 40, 128),
                                  (130, 130, True, 7, 128), (300, 300, True, 64, 32)):
        q, k, v = _qkv(2, s, 4, 2, hd, f32, s + t, device, t=t)
        seen(q, _fa_case(q, k, v, f"S={s} T={t} hd={hd} causal={causal} "
                                    f"window={win} scale=0.3", causal, win, scale=0.3))
    # strided views: q a slice of a wider projection, k/v transposed from [B, KV, T, hd]
    r = np.random.default_rng(5)
    wide = torch.as_tensor(r.normal(size=(2, 96, 8, 192)).astype(np.float32)).to(device)
    kt = torch.as_tensor(r.normal(size=(2, 4, 96, 64)).astype(np.float32)).to(device)
    vt = torch.as_tensor(r.normal(size=(2, 4, 96, 64)).astype(np.float32)).to(device)
    q, k, v = wide[..., 64:128], kt.transpose(1, 2), vt.transpose(1, 2)
    assert not (q.is_contiguous() or k.is_contiguous())
    seen(q, _fa_case(q, k, v, "on strided views (no copy)"))
    b, s, h, kv, hd = SERVE_BATCH, SERVE_PROMPT, 16, 8, 128
    for dtype, win in ((f32, None), (bf16, None), (f32, 512)):
        q, k, v = _qkv(b, s, h, kv, hd, dtype, 7, device)
        seen(q, _fa_case(q, k, v, f"serving shape [{b},{s},{h}/{kv},{hd}] {dtype} "
                                    f"causal window={win}", True, win,
                         rtol=1e-2 if dtype == bf16 else None))
        del q, k, v
    # the hardest f32 case for 3xTF32 (scale 0.3: sharp rows, P V dominated by
    # a few keys), on the GPU test's inputs: its error is printed, as the
    # margin under 2e-5 of the design's accumulation chains
    for win in (None, 512):
        q, k, v = _qkv(1, 2048, 16, 8, 128, f32, 4096, device)
        seen(q, _fa_case(q, k, v, f"[1,2048,16/8,128] causal window={win} scale=0.3 f32",
                         True, win, scale=0.3))
        del q, k, v
    # G = 1, 2, 4 (one or two q-heads per block, a group split over blocks), 3 (odd)
    for h, kv in ((4, 4), (4, 2), (8, 2), (6, 2)):
        for dtype in (f32, bf16):
            q, k, v = _qkv(2, 150, h, kv, 64, dtype, h * 10 + kv, device)
            seen(q, _fa_case(q, k, v, f"[2,150,{h}/{kv},64] G={h // kv} {dtype}"))
    for b, s, h, kv, hd, win in ZOO_FA_SHAPES:
        q, k, v = _qkv(b, s, h, kv, hd, f32, s + h, device)
        seen(q, _fa_case(q, k, v, f"zoo shape [{b},{s},{h}/{kv},{hd}] G={h // kv} f32 "
                                    f"causal window={win}", True, win))
        del q, k, v
    # a query row with no kept key gives 0 (the plain version gives NaN there)
    q, k, v = _qkv(1, 100, 2, 1, 64, f32, 3, device, t=10)
    got = fa.flash_attention(q, k, v, causal=False, window=5)
    torch.cuda.synchronize()
    want = fa.flash_attention_ref(q, k, v, causal=False, window=5)
    err = _max_err(got[:, :14], want[:, :14])
    check(bool((got[:, 14:] == 0).all()) and bool(torch.isnan(want[:, 14:]).all())
          and err <= FA_ATOL[f32],
          f"flash_attention: rows with no kept key give 0 (plain version NaN); the rest "
          f"max err {err:.2e}")
    q, k, v = _qkv(1, 16, 4, 2, 32, f32, 0, device)
    for bad in (lambda: fa.flash_attention(q.cpu(), k.cpu(), v.cpu()),            # CPU
                lambda: fa.flash_attention(q, k.cpu(), v),                         # devices
                lambda: fa.flash_attention(q.double(), k.double(), v.double()),    # dtype
                lambda: fa.flash_attention(q, k.to(bf16), v),
                lambda: fa.flash_attention(*_qkv(1, 16, 3, 2, 32, f32, 0, device)),  # H % KV
                lambda: fa.flash_attention(*_qkv(1, 16, 2, 2, 256, f32, 0, device)),  # hd > 128
                lambda: fa.flash_attention(*_qkv(1, 16, 2, 2, 48, f32, 0, device)),
                lambda: fa.flash_attention(q.transpose(2, 3), k.transpose(2, 3),  # last stride
                                           v.transpose(2, 3)),
                lambda: fa.flash_attention(                                  # rows 4 bytes off
                    torch.zeros(1, 16, 4, 33, device=device)[..., 1:], k, v),
                lambda: fa.flash_attention(                                  # rows 136 bytes apart
                    q, torch.zeros(1, 16, 2, 34, device=device)[..., :32], v)):
        try:
            bad()
        except (ValueError, TypeError):
            continue
        raise SystemExit("FAILED: flash_attention accepted an input its kernel does not take")
    log("  ok: flash_attention raises on CPU / mixed devices / dtype / H % KV / head_dim / "
        "last stride / rows off 16-byte boundaries")
    return {"max_abs_err": max(worst.values()), "max_abs_err_f32": worst[f32],
            "max_abs_err_bf16": worst[bf16]}


def _attention_pairs(s: int, t: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps for one (batch, head)."""
    q = np.arange(s)[:, None]
    k = np.arange(t)[None, :]
    keep = np.ones((s, t), bool)
    if causal:
        keep &= k <= q
    if window is not None:
        keep &= k > q - window
    return int(keep.sum())


def time_flash_attention(device) -> dict:
    """The kernel at the serving shape (B=4, S=T=2048, H=16, KV=8, hd=128,
    causal): f32 (the row), bf16 and window 512 (nested), each beside its
    plain version, ``scaled_dot_product_attention`` (``enable_gqa=True``; a
    boolean mask for the window) and its bound: 4 * hd operations per kept
    (query, key) pair per head, q/k/v read once and o written once. The
    operations' rate is that of the design that runs: bf16 on the bf16 tensor
    cores; f32 as 3xTF32, three TF32 products per product on the TF32 tensor
    cores (``bound_ms``), beside the CUDA-core f32 bound of the first design
    (``cuda_core_bound_ms``, a record)."""
    b, s, h, kv, hd = SERVE_BATCH, SERVE_PROMPT, 16, 8, 128
    out = {}
    for label, dtype, win in (("f32", torch.float32, None), ("bf16", torch.bfloat16, None),
                              ("window512", torch.float32, 512)):
        q, k, v = _qkv(b, s, h, kv, hd, dtype, 11, device)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None if win is None else layers.causal_mask(s, s, 0, win, device=device)
        esize = q.element_size()
        flops = 4 * hd * b * h * _attention_pairs(s, s, True, win)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

        sdpa_err = _max_err(library().transpose(1, 2),
                            fa.flash_attention_ref(q, k, v, window=win))
        nbytes = 2 * esize * (b * s * h * hd + b * s * kv * hd)
        f32 = dtype == torch.float32
        row = _timed(lambda: fa.flash_attention(q, k, v, window=win),
                     lambda: fa.flash_attention_ref(q, k, v, window=win), library,
                     nbytes, 3 * flops if f32 else flops,
                     f"one launch (one layer's prefill attention): B={b}, S=T={s}, H={h}, "
                     f"KV={kv}, hd={hd}, causal, window={win}, {dtype}",
                     flop_rate=hw.TF32_FLOP_PER_S if f32 else hw.BF16_FLOP_PER_S)
        row["bound_design"] = (
            f"3xTF32: 3 TF32 products per product at {hw.TF32_FLOP_PER_S / 1e12:g} TFLOP/s"
            if f32 else f"bf16 tensor cores at {hw.BF16_FLOP_PER_S / 1e12:g} TFLOP/s")
        if f32:
            row["cuda_core_bound_ms"] = max(nbytes / hw.HBM_BYTES_PER_S,
                                            flops / hw.F32_FLOP_PER_S) * 1e3
        row["library_max_abs_err"] = sdpa_err
        row["tflop_per_s"] = flops / row["ms"] / 1e9
        if label == "f32":
            out = row
        else:
            out[label] = row
        del q, k, v, qt, kt, vt
    log(f"  flash_attention: {json.dumps(out)}")
    return {"flash_attention": out}


# ------------------------------------------------------ training attention ----

# (label, B, S, H, KV, dqk, dv): one layer's attention of one vehicle in cell 6
# (Moonlight, the row) and cell 2 (granite, nested)
TRAIN_ATTN_SHAPES = (("moonlight_s8192", 1, 8192, 16, 16, 192, 128),
                     ("granite_s4096", 1, 4096, 16, 8, 64, 64))


def _sdpa_train(q, k, v, do=None):
    """The model's plain attention on the training path (``_sdpa`` with the
    causal mask); with ``do``, forward and backward."""
    from repro_torch.models import attention
    s = q.shape[1]
    mask = layers.causal_mask(s, s, 0, None, device=q.device)
    if do is None:
        with torch.no_grad():
            return attention._sdpa(q, k, v, mask, q.shape[-1] ** -0.5)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = attention._sdpa(*leaves, mask, q.shape[-1] ** -0.5)
    return (out,) + torch.autograd.grad(out, leaves, do)


def check_and_time_train_attention(device) -> tuple[dict, dict]:
    """The training kernels (rows 6t, 6b) at cells 6's and 2's per-layer
    shapes: o, dq, dk, dv against the exact f32 result (the plain twins on the
    bf16 inputs widened), each no worse than 2.5x ``_sdpa``'s own error on the
    same bf16 inputs (``tests/test_torch_cuda.py`` holds them element-wise),
    the backward the same bits twice; then timed against ``_sdpa`` (forward;
    forward and backward) and, as a yardstick the port never calls,
    ``F.scaled_dot_product_attention`` (``enable_gqa``). Bounds: the
    operations at the bf16 rate, 2 (dqk + dv) per kept (query, key) pair per
    head forward and 2 (3 dqk + 2 dv) backward (the five products; the design
    forms S and dP twice, 2 (4 dqk + 3 dv)); bytes: q, k, v, o (and dO, the
    gradients) once. Returns (worst errors, rows) keyed by kernel."""
    worst = {"flash_train_fwd": 0.0, "flash_train_bwd": 0.0}
    rows = {}
    for label, b, s, h, kv, dqk, dv in TRAIN_ATTN_SHAPES:
        gen = torch.Generator(device=device).manual_seed(s + dqk)
        mk = lambda *shape: torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        q, k, v, do = mk(b, s, h, dqk), mk(b, s, kv, dqk), mk(b, s, kv, dv), mk(b, s, h, dv)
        o, lse = fa.kernel.flash_train_forward(q, k, v)
        grads = fa.kernel.flash_train_backward(q, k, v, o, lse, do)
        again = fa.kernel.flash_train_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"flash_train backward at {label}: the same bits twice")
        f = lambda x: x.float()
        with torch.no_grad():
            eo, else_ = fa.flash_train_forward_ref(f(q), f(k), f(v))
            exact = (eo,) + fa.flash_train_backward_ref(f(q), f(k), f(v), eo, else_, f(do))
        plain = _sdpa_train(q, k, v, do)
        errs = {}
        for name, got, ex, pl in zip(("o", "dq", "dk", "dv"), (o,) + grads, exact, plain):
            errs[name] = (_max_err(got, ex), _max_err(pl.detach(), ex))
            check(errs[name][0] <= 2.5 * errs[name][1] + 1e-6,
                  f"flash_train {name} at {label}: max err {errs[name][0]:.3e} against the "
                  f"exact f32 result, _sdpa's {errs[name][1]:.3e} (at most 2.5x)")
        check(_max_err(lse, else_) <= 1e-4, f"flash_train lse at {label}: max err "
              f"{_max_err(lse, else_):.2e}")
        worst["flash_train_fwd"] = max(worst["flash_train_fwd"], errs["o"][0])
        worst["flash_train_bwd"] = max(worst["flash_train_bwd"],
                                       *(errs[n][0] for n in ("dq", "dk", "dv")))
        del eo, else_, exact, plain, grads, again

        pairs = _attention_pairs(s, s, True, None)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))

        def library_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

        def library_fwd_bwd():
            leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(out, leaves, dot)

        io = 2 * (b * s * h * (dqk + dv) + b * s * kv * (dqk + dv))   # q, k, v, o in bf16
        work = f"one layer of one vehicle: B={b}, S={s}, H={h}, KV={kv}, q/k {dqk}, v {dv}, causal, bf16"
        fwd = _timed(lambda: fa.kernel.flash_train_forward(q, k, v), lambda: _sdpa_train(q, k, v),
                     library_fwd, io + 4 * b * h * s, 2 * b * h * pairs * (dqk + dv),
                     f"forward (o and lse), {work}", flop_rate=hw.BF16_FLOP_PER_S,
                     inner=3, reps=5)
        bwd = _timed(lambda: fa.kernel.flash_train_backward(q, k, v, o, lse, do),
                     lambda: _sdpa_train(q, k, v, do), library_fwd_bwd,
                     2 * io + 12 * b * h * s, 2 * b * h * pairs * (3 * dqk + 2 * dv),
                     f"backward (dq, dk, dv; plain and library: forward and backward), {work}",
                     flop_rate=hw.BF16_FLOP_PER_S, inner=3, reps=5)
        bwd["kernel_fwd_bwd_ms"] = fwd["ms"] + bwd["ms"]
        bwd["design_flops_per_pair_head"] = 2 * (4 * dqk + 3 * dv)
        for name, row in (("flash_train_fwd", fwd), ("flash_train_bwd", bwd)):
            row["errors_vs_exact"] = {n: {"kernel": e[0], "sdpa": e[1]} for n, e in errs.items()}
            if label == TRAIN_ATTN_SHAPES[0][0]:
                rows[name] = row
            else:
                rows[name][label] = row
        del q, k, v, do, o, lse, qt, kt, vt, dot
        torch.cuda.empty_cache()
    log(f"  flash_train: {json.dumps(rows)}")
    return worst, rows


def _adamw_cell_config(arch: str, layers: int | None, held: int | None):
    cfg = get_config(arch)
    if layers is not None:
        cfg = replace(cfg, num_layers=layers)
    if held is not None:
        cfg = replace(cfg, expert_range=(0, held))
    return cfg


def _adamw_leaves(cfg, device, seed: int) -> list[list]:
    """One vehicle's p, g, mu, nu of ``cfg``'s leaves, as the train step's
    AdamW meets them: contiguous f32, the moments after a few steps."""
    shapes = [x.shape[1:] for x in steps.flatten(steps.train_state_specs(cfg, 1)[0]).values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda s, scale: scale * torch.randn(s, generator=gen, device=device)
    p = [draw(s, 0.02) for s in shapes]
    g = [draw(s, 1e-3) for s in shapes]
    mu = [draw(s, 1e-4) for s in shapes]
    nu = [m * m + draw(s, 1e-9).abs() for m, s in zip(mu, shapes)]
    return [p, g, mu, nu]


def check_and_time_adamw(device) -> tuple[dict, dict]:
    """Row 8: the AdamW kernel at one vehicle step's leaves of cells 6 and 2
    (ADAMW_CELLS). Each: one step through the train step's
    ``steps.adamw_step_`` (the kernel on the card) against its per-leaf loop
    (``steps.adamw_per_leaf_``) on a copy, p, mu and nu the same bits; then
    timed (CUDA events; the leaves are GBs, so every launch finds them cold
    in L2) against that loop and, as a yardstick the port never calls,
    ``torch._fused_adamw_``. Bound: 28 bytes a parameter (p, g, mu, nu read;
    p, mu, nu written) at the memory rate.
    Returns (the number of differing elements, 0; rows keyed by kernel)."""
    lr, rows, differ = 1e-3, {}, 0
    opt = optim_adamw(lr)
    for label, arch, layers, held in ADAMW_CELLS:
        cfg = _adamw_cell_config(arch, layers, held)
        p, g, mu, nu = _adamw_leaves(cfg, device, seed=len(label))
        n = sum(x.numel() for x in p)
        count = torch.full((), 3, dtype=torch.int32, device=device)
        want = [[x.clone() for x in xs] for xs in (p, g, mu, nu)]
        named = lambda xs: {str(i): x for i, x in enumerate(xs)}
        adamw_lib.kernel.reset_launch_counts()
        with torch.no_grad():
            steps.adamw_per_leaf_(opt, named(want[0]), named(want[2]), named(want[3]),
                                  named(want[1]), count)
            steps.adamw_step_(opt, named(p), named(mu), named(nu), named(g), count)
        torch.cuda.synchronize()
        bad = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                  for got, w in zip((p, mu, nu), (want[0], want[2], want[3]))
                  for x, y in zip(got, w))
        differ += bad
        launches = adamw_lib.kernel.launch_counts["adamw"]
        check(bad == 0 and launches == -(-len(p) // adamw_lib.kernel.max_leaves()),
              f"adamw at {label} ({len(p)} leaves, {n} parameters): {launches} launch(es), "
              f"{bad} elements of p / mu / nu differ from the per-leaf loop (0: bit for bit)")
        del want
        torch.cuda.empty_cache()
        library = None
        if hasattr(torch, "_fused_adamw_"):
            lib_steps = [torch.zeros((), device=device) for _ in p]
            library = lambda: torch._fused_adamw_(
                p, g, mu, nu, [], lib_steps, lr=lr, beta1=opt.hyper["b1"],
                beta2=opt.hyper["b2"], weight_decay=opt.hyper["weight_decay"],
                eps=opt.hyper["eps"], amsgrad=False, maximize=False)

        def plain():
            with torch.no_grad():
                steps.adamw_per_leaf_(opt, named(p), named(mu), named(nu), named(g), count)

        row = _timed(lambda: steps.adamw_step_(opt, named(p), named(mu), named(nu), named(g),
                                               count), plain,
                     library, 28 * n, 16 * n,
                     f"one vehicle step of {cfg.name} ({cfg.num_layers} layers"
                     f"{'' if held is None else f', {held} routed experts held'}): {len(p)} "
                     f"leaves, {n} f32 parameters, in place, {launches} launch(es); plain_ms: "
                     "the train step's per-leaf loop (optim.adamw on one-leaf dicts, copied "
                     "back); library_ms: torch._fused_adamw_ (a yardstick, not called by the "
                     "port)", inner=1, reps=5, warm=1)
        row.update({"cell": label, "parameters": n, "leaves": len(p),
                    "launches_per_step": launches,
                    "differing_elements": bad, "share_of_bound": row["bound_ms"] / row["ms"]})
        if not rows:
            rows["adamw"] = row
        else:
            rows["adamw"][label] = row
        del p, g, mu, nu
        torch.cuda.empty_cache()
    log(f"  adamw: {json.dumps(rows)}")
    return {"adamw": float(differ)}, rows


# -------------------------------------------------------------------- serve ----

def drive_serve(device: str, seed: int, rehearsal: bool) -> tuple[int, dict]:
    """qwen3-1.7b through ``launch.serve.generate`` (the main path of this
    phase, counters zeroed just before and read just after), then the three
    agreement checks. Returns the flash-attention launches of the main path
    and the report."""
    on_card = device != "cpu"
    cfg = get_config(SERVE_ARCH)
    b, s, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    if rehearsal:
        cfg, b, s, gen = cfg.reduced(), 2, 32, 4
    L = cfg.num_layers
    log(f"[serve] {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, f32; B={b}, prompt {s}, {gen} steps")
    generator = torch.Generator(device=device).manual_seed(seed)
    params, init_s = _seconds(lambda: transformer.init_params(generator, cfg, device=device))
    tokens = torch.randint(0, cfg.true_vocab_size, (b, s), generator=generator, device=device)
    impl = fa.make_attn_impl()
    serve.generate(params, tokens[:1, :64], cfg, gen=2, attn_impl=impl)   # warm-up

    # -- the main path
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    res = serve.generate(params, tokens, cfg, gen=gen, attn_impl=impl)
    launches = fa.kernel.launch_counts["flash_attention"]
    report = {
        "arch": cfg.name, "batch": b, "prompt": s, "gen": gen, "init_s": init_s,
        "prefill_s": res.prefill_s, "prefill_tokens_per_s": b * s / res.prefill_s,
        "decode_s": res.decode_s, "decode_ms_per_token": res.decode_s / gen * 1e3,
        "peak_device_memory_mb": (torch.cuda.max_memory_allocated() / 2**20
                                  if on_card else None),
        "flash_attention_launches": launches, "generated_ids_0": res.tokens[0, :16].tolist()}
    check(res.tokens.shape == (b, gen) and bool(torch.isfinite(res.last_logits).all())
          and bool(((res.tokens >= 0) & (res.tokens < cfg.true_vocab_size)).all())
          and res.cache_len == s + gen,
          f"generate: {gen} greedy tokens per prompt, finite logits, cache of {s + gen}")
    if on_card:
        check(launches == L, f"flash_attention launched {launches} times in prefill + "
              f"{gen} decode steps = {L} (one per layer in the prefill, none in decode)")

    # -- the kernel-path prefill against the plain-attention prefill
    with torch.no_grad(), full_f32_matmul():
        kernels_lib.reset_launch_counts()
        (lg_kernel, state), t_kernel = _seconds(lambda: transformer.prefill(
            params, tokens, cfg, attn_impl=impl, cache_dtype=torch.float32))
        n = fa.kernel.launch_counts["flash_attention"]
        del state
        (lg_plain, _), t_plain = _seconds(lambda: transformer.prefill(
            params, tokens, cfg, attn_impl=None, cache_dtype=torch.float32))
    err = _max_err(lg_kernel, lg_plain)
    same = float((lg_kernel.argmax(-1) == lg_plain.argmax(-1)).float().mean())
    report.update({"prefill_kernel_s": t_kernel, "prefill_plain_s": t_plain,
                   "prefill_logits_max_abs_diff": err, "argmax_agreement": same})
    if on_card:
        check(n == L, f"a prefill through the kernel launches it {n} = {L} times")
    check(err <= 2e-3, f"prefill through the kernel vs plain attention: last logits max diff "
          f"{err:.2e} (atol 2e-3), argmax agrees on {same:.0%} of prompts")
    del lg_kernel, lg_plain

    # -- prefill + one decode step against forward at position S
    s1 = min(256, s - 1)
    tok = tokens[:1, :s1 + 1]
    with torch.no_grad(), full_f32_matmul():
        full = transformer.forward(params, tok, cfg)
        last, state = transformer.prefill(params, tok[:, :s1], cfg, attn_impl=impl,
                                          cache_dtype=torch.float32)
        step, _ = transformer.decode_step(params, tok[:, s1:], serve.pad_cache(
            state, cfg, 1, s1 + 1), cfg)
    err_p, err_d = _max_err(last, full[:, s1 - 1]), _max_err(step, full[:, s1])
    report.update({"handoff_prefill_max_abs_diff": err_p, "handoff_decode_max_abs_diff": err_d})
    check(max(err_p, err_d) <= 2e-3, f"B=1, S={s1}: prefill (kernel) then one decode step vs "
          f"forward: {err_p:.2e} / {err_d:.2e} (atol 2e-3)")
    del full, state, params

    # -- the reduced config on the card against the CPU: same weights, same tokens
    small = get_config(SERVE_ARCH).reduced()
    cpu_params = transformer.init_params(torch.Generator().manual_seed(seed), small)
    cpu_tokens = torch.randint(0, small.true_vocab_size, (2, 64),
                               generator=torch.Generator().manual_seed(seed + 1))
    want = serve.generate(cpu_params, cpu_tokens, small, gen=8, attn_impl=impl)
    card_params = convert.transformer_params_from_numpy(cpu_params, device)
    got = serve.generate(card_params, cpu_tokens.to(device), small, gen=8, attn_impl=impl)
    err = max(_max_err(got.prefill_logits.cpu(), want.prefill_logits),
              _max_err(got.last_logits.cpu(), want.last_logits))
    same_tokens = bool(torch.equal(got.tokens.cpu(), want.tokens))
    report["reduced_card_vs_cpu_max_abs_diff"] = err
    check(err <= 1e-4 and same_tokens, f"{small.name} on {device} vs cpu: logits max diff "
          f"{err:.2e} (atol 1e-4), same {want.tokens.shape[1]} tokens: {same_tokens}")
    log(f"[serve] {json.dumps(report)}")
    return launches, report


# ---------------------------------------------------------------------- zoo ----

def _zoo_prefix(cfg, b: int, generator, device):
    """The frontend stub's prefix of a VLM / audio config (None otherwise):
    seeded raw features through ``multimodal.frontend_embeddings``."""
    if not cfg.embed_input:
        return None
    raw = torch.randn((b, cfg.frontend_tokens, multimodal.frontend_feature_dim(cfg)),
                      generator=generator, device=device)
    return multimodal.frontend_embeddings(cfg, raw)


def _first_layers(params: dict, cfg, depth: int):
    """The first ``depth`` layers of a model: its stacked block leaves sliced
    (views) and the config cut to match."""
    def cut(tree):
        return {k: cut(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[:depth]
    return {**params, "blocks": cut(params["blocks"])}, replace(cfg, num_layers=depth)


def _handoff(params: dict, cfg, tokens, prefix, impl) -> tuple[float, float]:
    """Prefill of ``tokens[:, :-1]`` then one decode step, against ``forward``
    of all of ``tokens`` at the last two positions: the two max abs diffs."""
    p = 0 if prefix is None else prefix.shape[1]
    s1 = tokens.shape[1] - 1
    with torch.no_grad(), full_f32_matmul():
        full = transformer.forward(params, tokens, cfg, prefix_embeds=prefix)
        last, state = transformer.prefill(params, tokens[:, :s1], cfg, prefix_embeds=prefix,
                                          attn_impl=impl, cache_dtype=torch.float32)
        step, _ = transformer.decode_step(params, tokens[:, s1:], serve.pad_cache(
            state, cfg, tokens.shape[0], p + s1 + 1), cfg)
    return _max_err(last, full[:, p + s1 - 1]), _max_err(step, full[:, p + s1])


def _rounding_noise(params: dict, cfg, tokens, prefix) -> float:
    """How far a rounding-sized change of the input moves this model's
    logits: ``forward`` with the embedding table scaled by ``1 + 1e-6 z`` (z
    standard normal, seeded: about 8 f32 ulps) against ``forward``, at the
    last two positions."""
    gen = torch.Generator(device=tokens.device).manual_seed(0)
    z = torch.randn(params["embed"].shape, generator=gen, device=tokens.device)
    nudged = {**params, "embed": params["embed"] * (1 + 1e-6 * z)}
    del z
    with torch.no_grad(), full_f32_matmul():
        a = transformer.forward(params, tokens, cfg, prefix_embeds=prefix)[:, -2:]
        b = transformer.forward(nudged, tokens, cfg, prefix_embeds=prefix)[:, -2:]
    return _max_err(a, b)


def drive_zoo_model(arch: str, depth: int | None, handoff_depth: int | None, device: str,
                    seed: int, rehearsal: bool) -> tuple[int, dict]:
    """One architecture through ``launch.serve.generate`` at full width (the
    main path of this phase, counters zeroed just before and read just after),
    then the agreement checks. Returns the flash-attention launches of the
    main path and the report."""
    on_card = device != "cpu"
    whole = get_config(arch)
    cfg = whole if depth is None else replace(whole, num_layers=depth)
    b, s, gen = ZOO_BATCH, ZOO_PROMPT, ZOO_GEN
    if rehearsal:
        cfg, b, s, gen = whole.reduced(), 2, 70, 4
        handoff_depth = None if handoff_depth is None else 1
    L = cfg.num_layers
    attn_layers = 0 if cfg.attn_free else L
    p = cfg.frontend_tokens if cfg.embed_input else 0
    weights_gib = cfg.param_count() * 4 / 2**30
    depth_note = (f"all {L} layers" if cfg.num_layers == whole.num_layers else
                  f"depth cut to {L} of {whole.num_layers} layers (f32 weights "
                  f"{whole.param_count() * 4 / 2**30:.1f} GiB whole)")
    log(f"[zoo] {cfg.name} [{cfg.family}]: {depth_note}; d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"experts {cfg.num_experts}/top-{cfg.top_k}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters ({weights_gib:.1f} GiB f32); "
        f"B={b}, prefix {p} + prompt {s}, {gen} steps")
    generator = torch.Generator(device=device).manual_seed(seed)
    params, init_s = _seconds(lambda: transformer.init_params(generator, cfg, device=device))
    tokens = torch.randint(0, cfg.true_vocab_size, (b, s), generator=generator, device=device)
    prefix = _zoo_prefix(cfg, b, generator, device)
    impl = fa.make_attn_impl(window=cfg.sliding_window)
    serve.generate(params, tokens[:1, :64], cfg, gen=2, attn_impl=impl,     # warm-up
                   prefix_embeds=None if prefix is None else prefix[:1])

    # -- the main path
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    res = serve.generate(params, tokens, cfg, gen=gen, attn_impl=impl, prefix_embeds=prefix)
    launches = fa.kernel.launch_counts["flash_attention"]
    report = {
        "arch": cfg.name, "family": cfg.family, "layers": L,
        "layers_whole": whole.num_layers, "batch": b, "prefix": p, "prompt": s, "gen": gen,
        "weights_gib": weights_gib, "init_s": init_s, "prefill_s": res.prefill_s,
        "prefill_tokens_per_s": b * (p + s) / res.prefill_s, "decode_s": res.decode_s,
        "decode_ms_per_token": res.decode_s / gen * 1e3,
        "peak_device_memory_mb": (torch.cuda.max_memory_allocated() / 2**20
                                  if on_card else None),
        "flash_attention_launches": launches, "generated_ids_0": res.tokens[0, :8].tolist()}
    check(res.tokens.shape == (b, gen) and bool(torch.isfinite(res.last_logits).all())
          and bool(torch.isfinite(res.prefill_logits).all())
          and bool(((res.tokens >= 0) & (res.tokens < cfg.true_vocab_size)).all())
          and res.cache_len == p + s + gen,
          f"{cfg.name} generate: {gen} greedy tokens per prompt in range, finite logits, "
          f"decode position {p + s + gen}")
    if on_card:
        check(launches == attn_layers, f"{cfg.name}: flash_attention launched {launches} "
              f"times in prefill + {gen} decode steps = {attn_layers} (one per attention "
              "layer in the prefill, none in decode)")

    with torch.no_grad(), full_f32_matmul():
        # -- the kernel-path prefill (the main path's) against the plain-attention prefill
        if attn_layers:
            (lg_plain, _), t_plain = _seconds(lambda: transformer.prefill(
                params, tokens, cfg, prefix_embeds=prefix, attn_impl=None,
                cache_dtype=torch.float32))
            err = _max_err(res.prefill_logits, lg_plain)
            report.update({"prefill_plain_s": t_plain, "prefill_logits_max_abs_diff": err})
            check(err <= 2e-3, f"{cfg.name} prefill through the kernel vs plain attention: "
                  f"last logits max diff {err:.2e} (atol 2e-3)")
            del lg_plain

    # -- prefill + one decode step against forward at position P + S
    s1 = min(256, s - 1)
    tok, pre1 = tokens[:1, :s1 + 1], None if prefix is None else prefix[:1]
    held = params, cfg
    if handoff_depth is not None:
        held = _first_layers(params, cfg, handoff_depth)
        full_p, full_d = _handoff(params, cfg, tok, pre1, impl)
        report.update({"handoff_full_depth_max_abs_diff": [full_p, full_d],
                       "rounding_noise_full_depth": _rounding_noise(params, cfg, tok, pre1)})
        log(f"  {cfg.name} at all {L} layers: handoff {full_p:.2e} / {full_d:.2e} beside a "
            f"rounding noise of {report['rounding_noise_full_depth']:.2e} (not held)")
    err_p, err_d = _handoff(*held, tok, pre1, impl)
    report.update({"handoff_layers": held[1].num_layers, "handoff_prefill_max_abs_diff": err_p,
                   "handoff_decode_max_abs_diff": err_d,
                   "rounding_noise": _rounding_noise(*held, tok, pre1)})
    check(max(err_p, err_d) <= 2e-3, f"{cfg.name} B=1, P={p}, S={s1}, {held[1].num_layers} "
          f"layers: prefill (kernel) then one decode step vs forward: {err_p:.2e} / "
          f"{err_d:.2e} (atol 2e-3; rounding noise {report['rounding_noise']:.2e})")
    del held, params, res, prefix, tokens

    # -- the reduced config on the card against the CPU: same weights, same inputs
    small = whole.reduced()
    cpu_params = transformer.init_params(torch.Generator().manual_seed(seed), small)
    cpu_gen = torch.Generator().manual_seed(seed + 1)
    cpu_tokens = torch.randint(0, small.true_vocab_size, (2, 70), generator=cpu_gen)
    cpu_prefix = _zoo_prefix(small, 2, cpu_gen, "cpu")
    small_impl = fa.make_attn_impl(window=small.sliding_window)
    want = serve.generate(cpu_params, cpu_tokens, small, gen=8, attn_impl=small_impl,
                          prefix_embeds=cpu_prefix)
    card_params = convert.transformer_params_from_numpy(cpu_params, device)
    got = serve.generate(card_params, cpu_tokens.to(device), small, gen=8,
                         attn_impl=small_impl,
                         prefix_embeds=None if cpu_prefix is None else cpu_prefix.to(device))
    err = max(_max_err(got.prefill_logits.cpu(), want.prefill_logits),
              _max_err(got.last_logits.cpu(), want.last_logits))
    same_tokens = bool(torch.equal(got.tokens.cpu(), want.tokens))
    report["reduced_card_vs_cpu_max_abs_diff"] = err
    check(err <= 1e-4 and same_tokens, f"{small.name} on {device} vs cpu: logits max diff "
          f"{err:.2e} (atol 1e-4), same {want.tokens.shape[1]} tokens: {same_tokens}")

    # -- MoE: the ragged path against the dense one at the reduced size, on the card
    if arch == "granite-moe-1b-a400m":
        with torch.no_grad(), full_f32_matmul():
            tok = cpu_tokens.to(device)
            dense = transformer.forward(card_params, tok, small)
            ragged = transformer.forward(card_params, tok, replace(small, moe_impl="ragged"))
        err = _max_err(ragged, dense)
        report["ragged_vs_dense_max_abs_diff"] = err
        check(err <= 1e-4, f"{small.name} on {device}: moe_impl='ragged' vs 'dense' forward "
              f"max diff {err:.2e} (atol 1e-4)")
    del card_params, cpu_params
    if on_card:
        torch.cuda.empty_cache()
    log(f"[zoo] {json.dumps(report)}")
    return launches, report


def drive_zoo(device: str, seed: int, rehearsal: bool) -> tuple[int, list]:
    """Every architecture of ``ZOO`` in turn, each freed before the next.
    Returns the flash-attention launches of the main paths and the reports."""
    t0 = time.perf_counter()
    if device != "cpu":
        torch.cuda.empty_cache()
    launches, reports = 0, []
    for arch, depth, handoff_depth in ZOO:
        n, report = drive_zoo_model(arch, depth, handoff_depth, device, seed, rehearsal)
        launches += n
        reports.append(report)
    log(f"[zoo] phase took {time.perf_counter() - t0:.1f} s; flash_attention {launches} "
        "launches over the six prefills")
    return launches, reports


# ------------------------------------------------------------------- train ----

def _apart(params: dict, generator, scale: float = 0.01) -> None:
    """Move every vehicle but the first off the common init, in place: the
    stack of vehicles that have trained apart (each leaf's rows then differ,
    so the mix is no identity)."""
    for leaf in steps.flatten(params).values():
        leaf[1:].add_(scale * torch.randn(leaf[1:].shape, generator=generator,
                                          device=leaf.device))


def _round_mixing(state_matrix, target, contact):
    """The mixing matrix a round computes from these inputs (P1, then the
    contact mask and renormalization), as ``steps.build_dds_train_step``
    does."""
    alpha = kl_solver.solve_p1_all(state_matrix, target, contact, num_steps=TRAIN_P1)
    return aggregation.mixing_from_alpha(alpha, contact)


def check_train_mix(params: dict, mixing) -> float:
    """The round's kernel mix (``ops.mix_params_cuda_``, in place, on a copy
    of each leaf) against the plain f32 product ``aggregation.mix_params`` on
    the same stacked leaves, one leaf at a time (the card holds no second copy
    of the stack). Returns the largest abs difference."""
    worst = 0.0
    with torch.no_grad(), full_f32_matmul():
        for name, leaf in steps.flatten(params).items():
            got = leaf.clone()
            ops.mix_params_cuda_(mixing, {name: got})
            want = aggregation.mix_params(mixing, {name: leaf})[name]
            worst = max(worst, _max_err(got, want))
            del got, want
    return worst


def mix_memory(params: dict, mixing) -> dict:
    """What one mix of the whole stack adds to the allocated device memory,
    in place (``ops.mix_params_cuda_``, the round's default) and functional
    (``ops.mix_params_cuda``, its output then freed): MiB above what was
    allocated before the call, at its peak."""
    out = {}
    flat = steps.flatten(params)
    with torch.no_grad():
        for what, fn in (("in_place", ops.mix_params_cuda_), ("functional", ops.mix_params_cuda)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mixed = fn(mixing, flat)
            torch.cuda.synchronize()
            out[f"mix_{what}_extra_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            out[f"mix_{what}_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
            del mixed
    return out


def _probe(params: dict) -> dict:
    """The first 4,096 entries of every leaf, copied: enough to see it move."""
    return {name: leaf.reshape(-1)[:4096].clone() for name, leaf in steps.flatten(params).items()}


def _moved(params: dict, probe: dict) -> float:
    return max(_max_err(steps.flatten(params)[name].reshape(-1)[:4096], p)
               for name, p in probe.items())


def _round_checks(name: str, history: list, state_matrix, moved: float) -> None:
    """What every train run holds: finite losses, the state matrix's rows on
    the simplex, parameters that moved."""
    rows = state_matrix.sum(dim=1).cpu()
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["kl"]) for m in history)
          and float((rows - 1).abs().max()) <= 1e-5 and moved > 0,
          f"{name}: {len(history)} rounds, finite loss / kl "
          f"{[round(m['loss'], 4) for m in history]} / {[round(m['kl'], 4) for m in history]}, "
          f"state rows sum to 1 (max dev {float((rows - 1).abs().max()):.1e}), "
          f"parameters moved (max {moved:.2e})")


def _train_report(cfg, whole, v: int, b: int, s: int, history: list, launches: dict,
                  on_card: bool, **extra) -> dict:
    secs = [m["seconds"] for m in history]
    return {"arch": cfg.name, "layers": cfg.num_layers, "layers_whole": whole.num_layers,
            "vehicles": v, "batch": b, "seq": s, "rounds": len(history),
            "first_round_s": secs[0],
            "seconds_per_round": statistics.mean(secs[1:]) if len(secs) > 1 else None,
            "loss": [m["loss"] for m in history], "kl": [m["kl"] for m in history],
            "peak_device_memory_mb": (torch.cuda.max_memory_allocated() / 2**20
                                      if on_card else None),
            **launches, **extra}


def _train_launches() -> dict:
    return {"gossip_mix_matmul_launches": kernel.launch_counts["gossip_mix_matmul"],
            "flash_attention_launches": fa.kernel.launch_counts["flash_attention"],
            "adamw_launches": adamw_lib.kernel.launch_counts["adamw"]}


def _check_adamw_launches(name: str, params: dict, v: int, rounds: int, got: int) -> None:
    """The train step's AdamW on the card: ceil(leaves / 64) kernel launches a
    vehicle step, E = 1 step a round."""
    want = rounds * v * -(-len(steps.flatten(params)) // adamw_lib.kernel.max_leaves())
    check(got == want, f"{name}: adamw launched {got} times = {rounds} rounds x {v} vehicles "
          f"x ceil({len(steps.flatten(params))} leaves / {adamw_lib.kernel.max_leaves()})")


def time_train_mix(params: dict, mixing) -> tuple[float, dict]:
    """Row 2t: ``gossip_mix_matmul`` at the train round's shape (the whole
    stacked model, V rows, one grouped launch): out of place against its
    plain version, then in place (on the stack, after the run's checks)
    against out of place bit for bit; then timed in place (what the round
    runs: ``ms``) and out of place, beside the plain version and
    ``torch.matmul`` per leaf. Returns (error, timing keys)."""
    flats = [leaf.view(leaf.shape[0], -1) for leaf in steps.flatten(params).values()]
    v, cols = flats[0].shape[0], sum(x.shape[1] for x in flats)
    path = kernel.matmul_path(v, v)
    with torch.no_grad(), full_f32_matmul():
        outs = kernel.gossip_mix_matmul_grouped(mixing, flats)
        err = 0.0
        for i, x in enumerate(flats):
            err = max(err, _max_err(outs[i], ref.gossip_mix_matmul_ref(mixing, x)))
        kernel.gossip_mix_matmul_grouped(mixing, flats, out=flats)
        torch.cuda.synchronize()
        same = all(torch.equal(o, x) for o, x in zip(outs, flats))
        check(same, f"gossip_mix_matmul in place at the train round's shape (path "
              f"{PATHS[path]}) equals out of place bit for bit")
        del outs
        timing = _timed(lambda: kernel.gossip_mix_matmul_grouped(mixing, flats, out=flats),
                        lambda: [ref.gossip_mix_matmul_ref(mixing, x) for x in flats],
                        lambda: [torch.matmul(mixing, x) for x in flats],
                        2 * v * cols * 4 + v * v * 4, 2 * v * v * cols,
                        f"the train round's mix: 1 grouped launch over {len(flats)} leaves, "
                        f"V={v}, {cols} columns per vehicle ({TRAIN_ARCH}, f32), mapping "
                        f"{PATHS[path]}; ms: in place (the round's default), "
                        f"out_of_place_ms: into new tensors; plain_ms / library_ms: "
                        f"{len(flats)} plain products / torch.matmul calls",
                        inner=1, reps=5, warm=1)
        oop = [time_ms(lambda: kernel.gossip_mix_matmul_grouped(mixing, flats),
                       inner=1, reps=5, warm=1) for _ in range(2)]
    timing.update({"out_of_place_ms": min(oop), "out_of_place_ms_repeat": oop,
                   "columns": cols, "path": PATHS[path],
                   "share_of_bound": timing["bound_ms"] / timing["ms"]})
    return err, timing


def drive_train_model(device: str, seed: int, rehearsal: bool) -> tuple[dict, float, dict,
                                                                       dict]:
    """qwen3-1.7b at full width through ``steps.build_dds_train_step``: V
    vehicles apart from one init, TRAIN_ROUNDS rounds (the main path of this
    phase, counters zeroed just before and read just after). Returns the
    report, the kernel's error at the round's shape, row 2t's timing and
    round 1 (loss, kl, ``_probe`` of the parameters after it)."""
    on_card = device != "cpu"
    whole = get_config(TRAIN_ARCH)
    cfg, v, b, s = whole, TRAIN_V, TRAIN_B, TRAIN_S
    if rehearsal:
        cfg, s = whole.reduced(), 32
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.4f} B f32 parameters per vehicle "
        f"({cfg.param_count() * 4 / 1e9:.2f} GB) + AdamW moments; V={v}, B={b}, S={s}, "
        f"{TRAIN_ROUNDS} rounds, lr {TRAIN_LR}, {TRAIN_P1} P1 steps, remat")
    gen = torch.Generator(device=device).manual_seed(seed)
    (params, opt, sm), init_s = _seconds(lambda: steps.init_train_state(cfg, v, gen,
                                                                        device=device))
    _apart(params, gen)
    contact = train_cli.ring_contact(v, device)
    target = torch.full((v,), 1.0 / v, device=device)
    timer = PhaseTimer(device)
    ts = steps.build_dds_train_step(cfg, lr=TRAIN_LR, p1_steps=TRAIN_P1, timer=timer)
    mix_err = None
    if on_card:
        mix_err = check_train_mix(params, _round_mixing(sm, target, contact))
        check(mix_err <= 1e-5, f"{cfg.name} round 1's mix through gossip_mix_matmul vs "
              f"aggregation.mix_params on the stacked leaves: max err {mix_err:.2e} (atol 1e-5)")
    probe = _probe(params)
    ptrs = {name: leaf.data_ptr() for name, leaf in steps.flatten(params).items()}

    # -- the main path
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    history = []
    for r in range(TRAIN_ROUNDS):
        tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen, device=device)
        t0 = time.perf_counter()
        params, opt, sm, metrics = ts.fn(params, opt, sm, tokens, contact, target)
        history.append({**{k: float(x) for k, x in metrics.items()},     # waits for the round
                        "seconds": time.perf_counter() - t0})
        if r == 0:
            first = timer.totals_ms()
            round1 = {"loss": history[0]["loss"], "kl": history[0]["kl"],
                      "probe": _probe(params)}
    launches = _train_launches()
    # the phases of the rounds after the first, per round
    spans = {name: (ms - first.get(name, 0.0)) / max(TRAIN_ROUNDS - 1, 1)
             for name, ms in timer.totals_ms().items()}
    report = _train_report(cfg, whole, v, b, s, history, launches, on_card,
                           init_s=init_s, mix_check_max_abs_err=mix_err,
                           first_round_device_ms=first, device_ms_per_round=spans)
    _round_checks(cfg.name, history, sm, _moved(params, probe))
    moved = [name for name, leaf in steps.flatten(params).items() if leaf.data_ptr() != ptrs[name]]
    check(not moved, f"{cfg.name}: after {TRAIN_ROUNDS} rounds every one of the "
          f"{len(ptrs)} parameter leaves is where it was (the mix writes into the stack; "
          f"moved: {moved})")
    if on_card:
        check(launches["gossip_mix_matmul_launches"] == TRAIN_ROUNDS
              and launches["flash_attention_launches"] == 0,
              f"{cfg.name}: gossip_mix_matmul launched {launches['gossip_mix_matmul_launches']} "
              f"times in {TRAIN_ROUNDS} rounds (one per round), flash_attention "
              f"{launches['flash_attention_launches']} (training attends through plain SDPA)")
        _check_adamw_launches(cfg.name, params, v, TRAIN_ROUNDS, launches["adamw_launches"])
        # what a mix of the stack adds to memory, moments alive as in the round
        report.update(mix_memory(params, _round_mixing(sm, target, contact).contiguous()))
        check(report["mix_in_place_extra_mb"] < 1.0,
              f"{cfg.name}: the in-place mix of the stack allocates "
              f"{report['mix_in_place_extra_mb']:.3f} MiB (the functional one "
              f"{report['mix_functional_extra_mb']:.1f} MiB): no second stack")
        log(f"  {cfg.name}: peak {report['peak_device_memory_mb']:.1f} MiB over the rounds; "
            f"a mix of the stack peaks at {report['mix_in_place_peak_mb']:.1f} MiB in place, "
            f"{report['mix_functional_peak_mb']:.1f} MiB functional; the mix span "
            f"{spans.get('mix', float('nan')):.2f} ms per round")

    # -- row 2t: the kernel at this round's shape, on the trained stack (moments freed)
    err, timing = None, {}
    if on_card:
        del opt
        torch.cuda.empty_cache()
        mixing = _round_mixing(sm, target, contact).contiguous()
        err, timing = time_train_mix(params, mixing)
        log(f"  gossip_mix_matmul/train: max err {err:.2e}; {json.dumps(timing)}")
        check(err <= 1e-5, f"gossip_mix_matmul at the train round's shape vs plain: "
              f"max err {err:.2e} (atol 1e-5)")
    del params
    if on_card:
        torch.cuda.empty_cache()
    log(f"[train] {json.dumps(report)}")
    return report, err, timing, round1


def drive_train_cli_transformer(device: str, seed: int, rehearsal: bool) -> dict:
    """granite-moe-1b-a400m at full width through the train CLI's entry point
    (``launch.train.main``, in this process so that its launches and memory
    are read): V=2, B=2, S=1,024, 3 steps, no checkpoint."""
    on_card = device != "cpu"
    whole = get_config(TRAIN_CLI_ARCH)
    s = 32 if rehearsal else TRAIN_S
    argv = ["--arch", TRAIN_CLI_ARCH, "--vehicles", str(TRAIN_V), "--steps", str(TRAIN_ROUNDS),
            "--per-vehicle-batch", str(TRAIN_B), "--seq-len", str(s), "--device", device,
            "--seed", str(seed)] + (["--reduced"] if rehearsal else [])
    cfg = whole.reduced() if rehearsal else whole
    log(f"[train] the train CLI in this process, launch.train.main: {' '.join(argv)} "
        f"({cfg.num_layers} layers, "
        f"{cfg.num_experts} experts top-{cfg.top_k}, {cfg.param_count() / 1e9:.4f} B "
        "parameters per vehicle)")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    params, opt, sm, history = train_cli.main(argv)
    launches = _train_launches()
    report = _train_report(cfg, whole, TRAIN_V, TRAIN_B, s, history, launches, on_card,
                           argv=argv)
    if on_card:
        _check_adamw_launches(f"{cfg.name} (CLI)", params, TRAIN_V, TRAIN_ROUNDS,
                              launches["adamw_launches"])
    del opt
    init = transformer.init_params(torch.Generator(device=device).manual_seed(seed), cfg,
                                   device=device)     # the CLI's init, drawn again
    moved = max(_max_err(leaf[0], steps.flatten(init)[name])
                for name, leaf in steps.flatten(params).items())
    del init, params
    _round_checks(cfg.name, history, sm, moved)
    if on_card:
        check(launches["gossip_mix_matmul_launches"] == TRAIN_ROUNDS
              and launches["flash_attention_launches"] == 0,
              f"{cfg.name} (CLI): gossip_mix_matmul launched "
              f"{launches['gossip_mix_matmul_launches']} times in {TRAIN_ROUNDS} steps, "
              f"flash_attention {launches['flash_attention_launches']}")
        torch.cuda.empty_cache()
    log(f"[train] {json.dumps(report)}")
    return report


def _reduced_round_case(arch: str, seed: int, v: int = 4):
    """A reduced config's federation of ``v`` vehicles mid-training: apart from
    one init, AdamW moments after three steps (so that the first step is not
    AdamW's sign-like one, which turns a gradient's rounding into a +-lr
    step), state vectors on the simplex; tokens and prefix. All on the CPU."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    params, opt, _ = steps.init_train_state(cfg, v, gen)
    _apart(params, gen)
    for mu, nu in zip(steps.flatten(opt.mu).values(), steps.flatten(opt.nu).values()):
        mu.normal_(0.0, 1e-3, generator=gen)          # second moments above the first's
        nu.uniform_(0.0, 1e-6, generator=gen).add_(2 * mu * mu)   # square, as in training
    opt.count.fill_(3)
    sm = torch.rand((v, v), generator=gen)
    sm = sm / sm.sum(dim=1, keepdim=True)
    tokens = torch.randint(0, cfg.true_vocab_size, (v, 2, 16), generator=gen)
    prefix = (0.02 * torch.randn((v, 2, cfg.frontend_tokens, cfg.d_model), generator=gen)
              if cfg.embed_input else None)
    return cfg, (params, opt, sm), tokens, prefix


def _reduced_round(cfg, state, tokens, prefix, device, **kw):
    """One round from ``state`` on ``device``; fails if a parameter leaf left
    its address (every mix writes into the stack)."""
    ts = steps.build_dds_train_step(cfg, lr=TRAIN_LR, p1_steps=TRAIN_P1, **kw)
    start = convert.train_state_from_numpy(*state, device=device)
    ptrs = {name: leaf.data_ptr() for name, leaf in steps.flatten(start[0]).items()}
    v = tokens.shape[0]
    with full_f32_matmul():
        out = ts.fn(*start, tokens.to(device), train_cli.ring_contact(v, device),
                    torch.full((v,), 1.0 / v, device=device),
                    None if prefix is None else prefix.to(device))
    if {name: leaf.data_ptr() for name, leaf in steps.flatten(out[0]).items()} != ptrs:
        raise SystemExit(f"FAILED: {cfg.name} on {device}: a parameter leaf moved in the round")
    return out


def check_reduced_rounds(device: str, seed: int) -> dict:
    """One round of every architecture's reduced config on the card against
    the same round on the CPU (same state, tokens, prefix; atol 1e-4 on loss,
    kl, state matrix, parameters); on the card also the reduced qwen3 at the
    first V past the column mapping's limit (the round's mix functional through
    the tiles, one launch, copied back; every leaf in place); then the
    ``gossip_bf16`` variant's round of the reduced qwen3 against its f32 round
    (2e-2 of each leaf's scale)."""
    worst = {}
    for arch in sorted(ARCHITECTURES):
        cfg, state, tokens, prefix = _reduced_round_case(arch, seed)
        want = _reduced_round(cfg, state, tokens, prefix, "cpu")
        got = _reduced_round(cfg, state, tokens, prefix, device)
        err = max([abs(float(got[3][k]) - float(want[3][k])) for k in ("loss", "kl")]
                  + [_max_err(got[2].cpu(), want[2])]
                  + [_max_err(x.cpu(), steps.flatten(want[0])[k])
                     for k, x in steps.flatten(got[0]).items()])
        worst[arch] = err
        check(err <= 1e-4, f"{cfg.name}: one round on {device} vs cpu (4 vehicles): loss, kl, "
              f"state matrix, parameters max diff {err:.2e} (atol 1e-4)")
    # past the column mapping's limit the default mix is functional (the tiles),
    # copied back (the CPU asks no library: there every mix is in place)
    if device != "cpu":
        v = next(k for k in range(1, 129) if kernel.matmul_path(k, k) == kernel.MATMUL_TILES)
        cfg, state, tokens, prefix = _reduced_round_case(TRAIN_ARCH, seed, v)
        want = _reduced_round(cfg, state, tokens, prefix, "cpu")
        kernel.reset_launch_counts()
        got = _reduced_round(cfg, state, tokens, prefix, device)
        err = max([abs(float(got[3][k]) - float(want[3][k])) for k in ("loss", "kl")]
                  + [_max_err(got[2].cpu(), want[2])]
                  + [_max_err(x.cpu(), steps.flatten(want[0])[k])
                     for k, x in steps.flatten(got[0]).items()])
        worst[f"{TRAIN_ARCH}/V={v}"] = err
        check(err <= 1e-4 and kernel.launch_counts["gossip_mix_matmul"] == 1,
              f"{cfg.name}: one round of {v} vehicles (past the column mapping) on {device} vs "
              f"cpu: max diff {err:.2e} (atol 1e-4), gossip_mix_matmul launched "
              f"{kernel.launch_counts['gossip_mix_matmul']} time(s) (the tiles, copied back; "
              "every leaf in place)")
    cfg, state, tokens, prefix = _reduced_round_case(TRAIN_ARCH, seed)
    f32 = _reduced_round(cfg, state, tokens, prefix, device)
    _, overrides = variants.apply_variant("gossip_bf16", cfg, "train")
    low = _reduced_round(cfg, state, tokens, prefix, device, **overrides)
    rel = max(_max_err(x, steps.flatten(f32[0])[k])
              / float(steps.flatten(f32[0])[k].abs().max().clamp(min=1.0))
              for k, x in steps.flatten(low[0]).items())
    worst["gossip_bf16_relative"] = rel
    check(rel <= 2e-2, f"{cfg.name} on {device}: the gossip_bf16 round's parameters within "
          f"{rel:.2e} of the f32 round's, relative to each leaf's scale (2e-2)")
    return worst


def drive_train(device: str, seed: int, rehearsal: bool) -> tuple[int, float, dict, dict,
                                                                 dict]:
    """The train phase. Returns the gossip_mix_matmul launches of its main
    paths, row 2t's error and timing, the report and qwen3's round 1."""
    t0 = time.perf_counter()
    if device != "cpu":
        torch.cuda.empty_cache()
    report = {}
    report["model"], err, timing, round1 = drive_train_model(device, seed, rehearsal)
    report["cli"] = drive_train_cli_transformer(device, seed, rehearsal)
    log("[train] one round of every reduced architecture, card against CPU")
    report["reduced"] = check_reduced_rounds(device, seed)
    launches = (report["model"]["gossip_mix_matmul_launches"]
                + report["cli"]["gossip_mix_matmul_launches"])
    log(f"[train] phase took {time.perf_counter() - t0:.1f} s; gossip_mix_matmul {launches} "
        "launches over the two runs")
    return launches, err, timing, report, round1


# -------------------------------------------------------------- mesh-train ----

def _mesh_round(ts, mesh, state, tokens, contact, target, prefix=None):
    """One round of a mesh step from the stacked ``state`` placed on ``mesh``;
    returns the outputs with every tensor this rank's local one."""
    placed = convert.place_train_state(state, mesh, ts.in_specs)
    params, opt, sm, metrics = ts.fn(*placed, tokens, contact, target, prefix)
    local = lambda tree: {k: x.to_local() for k, x in steps.flatten(tree).items()}
    return (local(params), local(opt.mu), local(opt.nu), sm.to_local(),
            {k: float(x) for k, x in metrics.items()})


def check_mesh_reduced_rounds(device: str, seed: int, mesh) -> dict:
    """One round of every reduced architecture on ``mesh`` against its
    mesh-less round on ``device`` (same state, tokens, prefix; 1e-5 on loss,
    kl, state matrix and parameters)."""
    worst = {}
    for arch in sorted(ARCHITECTURES):
        cfg, state, tokens, prefix = _reduced_round_case(arch, seed)
        want = _reduced_round(cfg, state, tokens, prefix, device)
        v = tokens.shape[0]
        ts = steps.build_dds_train_step(cfg, mesh=mesh, lr=TRAIN_LR, p1_steps=TRAIN_P1)
        with full_f32_matmul():
            got = _mesh_round(ts, mesh, convert.train_state_from_numpy(*state, device=device),
                              tokens.to(device), train_cli.ring_contact(v, device),
                              torch.full((v,), 1.0 / v, device=device),
                              None if prefix is None else prefix.to(device))
        err = max([abs(got[4][k] - float(want[3][k])) for k in ("loss", "kl")]
                  + [_max_err(got[3], want[2])]
                  + [_max_err(x, steps.flatten(want[0])[k]) for k, x in got[0].items()])
        worst[arch] = err
        check(err <= 1e-5, f"{cfg.name}: one round on the mesh vs without it on {device} "
              f"(4 vehicles): loss, kl, state matrix, parameters max diff {err:.2e} (atol 1e-5)")
    return worst


def time_mesh_mix(flat: dict, mixing, shard) -> tuple[float, dict]:
    """Row 2m: the mesh round's own mix (``steps.mix_rows`` on this rank's
    local tensors, as the round runs it) against its plain version
    (``aggregation.mix_params``) on the same inputs: the plain mix out of
    place, then the mesh mix written into the leaves, compared leaf by leaf;
    then both timed (the mesh mix in place, what the round runs), beside
    ``torch.matmul`` per leaf. Returns (error, timing keys)."""
    leaves = list(flat.values())
    v, cols = leaves[0].shape[0], sum(x[0].numel() for x in leaves)
    path = kernel.matmul_path(v, v)
    with torch.no_grad(), full_f32_matmul():
        want = aggregation.mix_params(mixing, flat)
        steps.mix_rows(mixing, flat, shard)
        torch.cuda.synchronize()
        err = max(_max_err(flat[name], want[name]) for name in flat)
        del want
        timing = _timed(lambda: steps.mix_rows(mixing, flat, shard),
                        lambda: aggregation.mix_params(mixing, flat),
                        lambda: [torch.matmul(mixing, x.view(v, -1)) for x in leaves],
                        2 * v * cols * 4 + v * v * 4, 2 * v * v * cols,
                        f"the mesh round's mix: steps.mix_rows on the {len(leaves)} local "
                        f"leaves of the one-rank mesh (V={v}, {cols} columns per vehicle, "
                        f"{TRAIN_ARCH}, f32, mapping {PATHS[path]}), in place as the round "
                        f"runs it; plain_ms: aggregation.mix_params; library_ms: "
                        f"{len(leaves)} torch.matmul calls",
                        inner=1, reps=5, warm=1)
    timing.update({"columns": cols, "path": PATHS[path]})
    return err, timing


def drive_mesh_train(device: str, seed: int, rehearsal: bool,
                     round1: dict) -> tuple[int, float, dict, dict]:
    """The mesh-train phase: the train phase's qwen3 round 1 and a second
    round through ``build_dds_train_step(cfg, mesh=mesh)`` on a one-rank
    group (NCCL on the card), the first against the mesh-less round 1, the
    second timed apart from the first (DTensor's first-call dispatch); then
    the mesh round's mix timed on its own inputs (row 2m); then every reduced
    architecture. Returns the rounds' gossip_mix_matmul launches, the mesh
    mix's error and timing, and the report."""
    t_phase = time.perf_counter()
    on_card = device != "cpu"
    whole = get_config(TRAIN_ARCH)
    cfg, v, b, s = whole, TRAIN_V, TRAIN_B, TRAIN_S
    if rehearsal:
        cfg, s = whole.reduced(), 32
    workdir = tempfile.mkdtemp(prefix="mesh_train_")
    mesh_lib.initialize_multihost(init_method=f"file://{workdir}/store", num_processes=1,
                                  process_id=0, transport="nccl" if on_card else "gloo")
    try:
        mesh = mesh_lib.make_federation_mesh(vehicle=1, fsdp=1, model=1, explicit=True)
        log(f"[mesh-train] {cfg.name} on mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
            f"({mesh.device_type}, transport {mesh_lib.transport()}): V={v}, B={b}, S={s}, "
            "two rounds from the train phase's first state")
        # the train phase's first round, drawn again from the same seed
        gen = torch.Generator(device=device).manual_seed(seed)
        state = steps.init_train_state(cfg, v, gen, device=device)
        _apart(state[0], gen)
        contact = train_cli.ring_contact(v, device)
        target = torch.full((v,), 1.0 / v, device=device)
        tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen, device=device)
        timers = [PhaseTimer(device), PhaseTimer(device)]
        rounds = [steps.build_dds_train_step(cfg, mesh=mesh, lr=TRAIN_LR, p1_steps=TRAIN_P1,
                                             timer=t) for t in timers]
        placed = convert.place_train_state(state, mesh, rounds[0].in_specs)
        del state
        # -- the main path of this phase: two rounds
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels_lib.reset_launch_counts()
        history, sm_in = [], None
        for ts in rounds:
            sm_in = placed[2]
            t0 = time.perf_counter()
            params, opt, sm, metrics = ts.fn(*placed, tokens, contact, target)
            got = {k: float(x) for k, x in metrics.items()}     # waits for the round
            history.append({"seconds": time.perf_counter() - t0, **got})
            if len(history) == 1:
                local = {k: x.to_local() for k, x in steps.flatten(params).items()}
                probe_err = max(_max_err(local[name].reshape(-1)[:4096], p)
                                for name, p in round1["probe"].items())
                err = max([abs(got[k] - round1[k]) for k in ("loss", "kl")] + [probe_err])
                del local
            placed = (params, opt, sm)
        launches = _train_launches()
        peak = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
        report = {"arch": cfg.name, "vehicles": v, "batch": b, "seq": s,
                  "first_round_s": history[0]["seconds"],
                  "second_round_s": history[1]["seconds"],
                  "loss": [m["loss"] for m in history], "kl": [m["kl"] for m in history],
                  "max_diff_vs_meshless_round1": err, "peak_device_memory_mb": peak,
                  "device_ms": [t.totals_ms() for t in timers], **launches}
        check(err <= 1e-5, f"{cfg.name}: the mesh round's loss {history[0]['loss']:.6f}, kl "
              f"{history[0]['kl']:.6f} and parameters within {err:.2e} of the mesh-less "
              "round 1 (atol 1e-5)")
        check(all(np.isfinite(m["loss"]) and np.isfinite(m["kl"]) for m in history),
              f"{cfg.name}: the second mesh round's loss and kl are finite")
        if on_card:
            check(launches["gossip_mix_matmul_launches"] >= 1
                  and launches["flash_attention_launches"] == 0,
                  f"{cfg.name} on the mesh: gossip_mix_matmul launched "
                  f"{launches['gossip_mix_matmul_launches']} time(s), flash_attention "
                  f"{launches['flash_attention_launches']}")
            _check_adamw_launches(f"{cfg.name} on the mesh (each rank's shards)", params, v,
                                  len(rounds), launches["adamw_launches"])
        # -- the mesh mix on the second round's own inputs (row 2m)
        mix_err, mix_timing = 0.0, {}
        placed = None
        del opt                     # the moments: room for the plain mix's output
        if on_card:
            torch.cuda.empty_cache()
            mixing = aggregation.mixing_from_alpha(kl_solver.solve_p1_all(
                sm_in.full_tensor(), target, contact, num_steps=TRAIN_P1), contact)
            flat = {k: x.to_local() for k, x in steps.flatten(params).items()}
            mix_err, mix_timing = time_mesh_mix(flat, mixing, steps._vehicle_shard(mesh))
            report["mix"] = {"max_abs_err": mix_err, **mix_timing}
            check(mix_err <= 1e-5, f"the mesh round's mix (steps.mix_rows) against "
                  f"aggregation.mix_params on its own inputs: max diff {mix_err:.2e} "
                  "(atol 1e-5)")
            del flat
        del params, sm, sm_in
        if on_card:
            torch.cuda.empty_cache()
        log(f"[mesh-train] {json.dumps(report)}")
        log("[mesh-train] one round of every reduced architecture, on the mesh and without")
        report["reduced"] = check_mesh_reduced_rounds(device, seed, mesh)
    finally:
        mesh_lib.shutdown()
    log(f"[mesh-train] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches["gossip_mix_matmul_launches"], mix_err, mix_timing, report


# ------------------------------------------------------------------ dryrun ----

# (arch, shapes, variant): one dry-run process each
DRYRUN_PAIRS = (("qwen3-1.7b", ("train_4k", "prefill_32k", "decode_32k"), "baseline"),
                ("mixtral-8x7b", ("train_4k",), "baseline"),
                ("granite-moe-1b-a400m", ("decode_32k",), "ragged_moe"))


def start_dryrun(rehearsal: bool) -> dict:
    """The dry run's CLI, one process per architecture, started now on the
    host (no card visible to them); ``finish_dryrun`` collects them."""
    root = Path(__file__).resolve().parent
    workdir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "CUDA_VISIBLE_DEVICES": ""}
    pairs = ((("qwen3-1.7b", ("long_500k",), "baseline"),
              ("granite-moe-1b-a400m", ("long_500k",), "ragged_moe"))
             if rehearsal else DRYRUN_PAIRS)
    procs = {}
    atexit.register(_stop_dryrun, procs)
    for arch, shapes, variant in pairs:
        name = f"{arch}.{variant}"
        out = workdir / f"{name}.jsonl"
        log_file = open(workdir / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             *shapes, "--variant", variant, "--out", str(out)], cwd=root, env=env,
            stdout=log_file, stderr=subprocess.STDOUT), out, log_file)
    return {"workdir": workdir, "env": env, "root": root, "procs": procs,
            "t0": time.perf_counter()}


def _stop_dryrun(procs: dict) -> None:
    """At exit: end any dry-run process still running (a phase failed first)."""
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def finish_dryrun(run: dict) -> dict:
    """Wait for the dry-run processes, read their records, run the roofline
    CLI on them, check and print each pair."""
    records = []
    for name, (proc, out, log_file) in run["procs"].items():
        rc = proc.wait(timeout=900)
        log_file.close()
        if rc != 0:
            tail = (run["workdir"] / f"{name}.log").read_text()[-3000:]
            raise SystemExit(f"FAILED: the dry run of {name} exited {rc}:\n{tail}")
        records += [json.loads(line) for line in out.read_text().splitlines() if line]
    wall = time.perf_counter() - run["t0"]
    paths = [str(out) for _, out, _ in run["procs"].values()]
    table = subprocess.run([sys.executable, "-m", "repro_torch.roofline.analysis", *paths],
                           cwd=run["root"], env=run["env"], capture_output=True, text=True,
                           timeout=300)
    check(table.returncode == 0, f"python -m repro_torch.roofline.analysis exited "
          f"{table.returncode} {table.stderr[-2000:]}")
    for line in table.stdout.splitlines():
        log(f"  {line}")
    report = {}
    for rec in records:
        tag = f"{rec['arch']} x {rec['shape']} ({rec['variant']})"
        check("error" not in rec, f"dry run {tag}: no error ({rec.get('error')})")
        row = roofline.analyze_record(rec)
        chips = row.chips
        coll = rec["collective_bytes_per_device"]
        if rec["shape"].startswith("train"):
            check(rec["flops_per_device"] * chips >= row.model_flops,
                  f"dry run {tag}: flops_per_device x {chips} = "
                  f"{rec['flops_per_device'] * chips:.3e} >= model_flops {row.model_flops:.3e}")
            check(coll.get("reduce-scatter", 0) > 0,
                  f"dry run {tag}: a reduce-scatter (the gossip mix): {coll}")
        else:
            check(sum(coll.values()) > 0, f"dry run {tag}: at least one collective: {coll}")
        log(f"[dryrun] {tag}: {json.dumps(rec)}")
        log(f"  H100 row: dominant {row.dominant}, compute {row.compute_s:.3e} s, memory "
            f"{row.memory_s:.3e} s, collective {row.collective_s:.3e} s, useful ratio "
            f"{row.useful_ratio:.3f}; run_s {rec['run_s']:.1f}")
        report[tag] = {"run_s": rec["run_s"], "dominant": row.dominant,
                       "useful_ratio": row.useful_ratio}
    log(f"[dryrun] {len(records)} pairs in {wall:.1f} s of wall time beside the card's phases")
    return report


# ------------------------------------------------------------------ ragged ----

def _grouped_inputs(m: int, e: int, d: int, f: int, dtype, seed: int, device):
    """x [M, d], w [E, d, f], dy [M, f] and the offsets of group sizes drawn
    from a Dirichlet over the experts with two of them empty (the first and
    the middle one), as a router's sorted assignments fall."""
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(e))
    p[[0, e // 2]] = 0.0
    sizes = r.multinomial(m, p / p.sum())
    offsets = torch.as_tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
                              device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((m, d), generator=g, device=device) * d ** -0.5).to(dtype)
    w = torch.randn((e, d, f), generator=g, device=device).to(dtype)
    dy = torch.randn((m, f), generator=g, device=device).to(dtype)
    return x, w, dy, offsets, sizes


def _grouped_agrees(got, want, dtype) -> tuple[float, bool]:
    err = _max_err(got, want)
    if dtype == torch.float32:      # 1e-5 of the plain version's scale (f32 sums of d terms)
        return err, err <= 1e-5 * max(1.0, float(want.float().abs().max()))
    return err, bool(torch.allclose(got.float(), want.float(), atol=5e-2, rtol=3e-2))


def _library_grouped(call, loop, dtype, what: str):
    """The one PyTorch call for a grouped product (``torch._grouped_mm``),
    checked against the loop of per-group ``torch.matmul``s first, where this
    torch takes the dtype; else that loop. Returns (callable, name)."""
    try:
        out = call()
        torch.cuda.synchronize()
        if _grouped_agrees(out, loop(), dtype)[1]:
            return call, what
        log(f"    {what} disagrees with the loop on {dtype}")
    except Exception as exc:  # noqa: BLE001 — this torch does not take it
        log(f"    {what} refuses {dtype}: {type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}")
    return loop, "per-group torch.matmul loop"


def _time_grouped(fn, plain, library, m: int, d: int, f: int, groups: int, e_out: int,
                  esize: int, f32: bool, work: str, **time_kw) -> dict:
    """``_timed``'s keys for one grouped product, its bound by the design that
    runs: the bytes this run's data needs (x and the other operand read once;
    forward reads the weights of the ``groups`` experts that hold a row, wgrad
    writes all ``e_out`` of dw) against its operations, bf16 on the bf16 tensor
    cores and f32 as 3xTF32 (three TF32 products per product); the CUDA-core
    f32 bound of the first design beside it (``cuda_core_bound_ms``, a record),
    and the rate reached (useful flops over the kernel's time)."""
    nbytes = (m * d + m * f + max(groups, e_out) * d * f) * esize
    flops = 2 * m * d * f
    row = _timed(fn, plain, library, nbytes, 3 * flops if f32 else flops, work,
                 flop_rate=hw.TF32_FLOP_PER_S if f32 else hw.BF16_FLOP_PER_S, **time_kw)
    row["bound_design"] = (
        f"3xTF32: 3 TF32 products per product at {hw.TF32_FLOP_PER_S / 1e12:g} TFLOP/s"
        if f32 else f"bf16 tensor cores at {hw.BF16_FLOP_PER_S / 1e12:g} TFLOP/s")
    if f32:
        row["cuda_core_bound_ms"] = max(nbytes / hw.HBM_BYTES_PER_S,
                                        flops / hw.F32_FLOP_PER_S) * 1e3
    row["tflop_per_s"] = flops / row["ms"] / 1e9
    return row


def check_grouped_kernels(device) -> tuple[dict, dict]:
    """``grouped_mm`` (and its transposed product, the input gradient) and
    ``grouped_mm_wgrad`` against their plain versions on the card, f32 and
    bf16, at the MoE prefill shapes of ``RAGGED_SHAPES`` (two experts empty)
    and granite-moe's decode step (16 rows over 32 experts); then each one's
    time beside its bound (``_time_grouped``), its plain version's and the
    library's, and its working tiles against the persistent grid (the
    schedule's mirror, ``kernel.tile_schedule``, and the grid the launcher
    takes). Returns the worst errors and the kernels-line timing keys
    (granite-moe's f32 prefill shape in the row, every shape under
    ``shapes``)."""
    worst = {"grouped_mm": 0.0, "grouped_mm_wgrad": 0.0}
    rows = {"grouped_mm": [], "grouped_mm_wgrad": []}
    shapes = [("prefill",) + shape for shape in RAGGED_SHAPES] + [("decode",) + RAGGED_DECODE_SHAPE]
    for kind, arch, m, e, d, f in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy, offsets, sizes = _grouped_inputs(m, e, d, f, dtype, m + e, device)
            bounds = list(zip(np.concatenate([[0], np.cumsum(sizes)])[:-1].tolist(),
                              np.cumsum(sizes).tolist()))
            f32 = dtype == torch.float32
            tag = f"{arch} {kind} {dtype}: M={m}, E={e}, d={d}, f={f}, groups {sizes.tolist()}"
            with full_f32_matmul():
                cases = {
                    "grouped_mm": (lambda: gmm.kernel.grouped_mm(x, w, offsets),
                                   lambda: gmm.grouped_mm_ref(x, w, offsets)),
                    "grouped_mm/trans": (
                        lambda: gmm.kernel.grouped_mm(dy, w, offsets, trans_w=True),
                        lambda: gmm.grouped_mm_ref(dy, w, offsets, trans_w=True)),
                    "grouped_mm_wgrad": (lambda: gmm.kernel.grouped_mm_wgrad(x, dy, offsets),
                                         lambda: gmm.grouped_mm_wgrad_ref(x, dy, offsets)),
                }
                for name, (fn, plain) in cases.items():
                    got = fn()
                    torch.cuda.synchronize()
                    err, ok = _grouped_agrees(got, plain(), dtype)
                    key = name.split("/")[0]
                    worst[key] = max(worst[key], err)
                    check(ok, f"{name} vs plain, {tag}: max err {err:.2e}")
                    del got
                esize = x.element_size()
                used = int((sizes > 0).sum())
                time_kw = dict(inner=2, reps=5, warm=2) if kind == "prefill" else {}
                ends = offsets[1:].contiguous()
                tiles = {}
                for mode, k_, n_ in (("forward", d, f), ("wgrad", d, f)):
                    sched = gmm.kernel.tile_schedule(offsets.cpu(), m, k_, n_, dtype,
                                                     wgrad=mode == "wgrad")
                    tiles[mode] = {"working": sched["count"], "bound": sched["bound"],
                                   "grid": gmm.kernel.launch_grid(m, k_, n_, e, dtype, mode)}
                library, lib_name = _library_grouped(
                    lambda: torch._grouped_mm(x, w, offs=ends),
                    lambda: torch.cat([x[lo:hi] @ w[i] for i, (lo, hi) in enumerate(bounds)]),
                    dtype, "torch._grouped_mm(x, w)")
                row = _time_grouped(cases["grouped_mm"][0], cases["grouped_mm"][1], library,
                                    m, d, f, used, 0, esize, f32,
                                    f"{tag}; library: {lib_name}", **time_kw)
                row["tiles"] = tiles["forward"]
                rows["grouped_mm"].append({"arch": arch, "kind": kind, "dtype": str(dtype), **row})
                # the weight gradient's one call: 2-D x 2-D, the offsets along
                # the summed axis, [d, M] x [M, f] -> [E, d, f]
                wlib, wlib_name = _library_grouped(
                    lambda: torch._grouped_mm(x.t(), dy, offs=ends),
                    lambda: torch.stack([x[lo:hi].T @ dy[lo:hi] for lo, hi in bounds]),
                    dtype, "torch._grouped_mm(x.T, dy)")
                row = _time_grouped(cases["grouped_mm_wgrad"][0], cases["grouped_mm_wgrad"][1],
                                    wlib, m, d, f, used, e, esize, f32,
                                    f"{tag}; library: {wlib_name}", **time_kw)
                row["tiles"] = tiles["wgrad"]
                rows["grouped_mm_wgrad"].append({"arch": arch, "kind": kind,
                                                 "dtype": str(dtype), **row})
            for name in rows:
                log(f"  {name} {json.dumps(rows[name][-1])}")
            del x, w, dy, offsets
            torch.cuda.empty_cache()
    # the row: granite-moe's f32 prefill shape, the phase's main path
    timings = {name: {**{k: v for k, v in r[0].items() if k not in ("arch", "kind", "dtype")},
                      "shapes": r} for name, r in rows.items()}
    return worst, timings


def _ragged_launches() -> dict:
    return dict(gmm.kernel.launch_counts)


def drive_ragged_serve(device: str, seed: int, rehearsal: bool) -> tuple[dict, dict]:
    """granite-moe-1b-a400m at full width (24/24 layers) through
    ``launch.serve.generate`` with ``moe_impl="ragged"`` (the main path of this
    phase, counters zeroed just before and read just after): 2 x 1,024 tokens,
    16 greedy steps; then the dense MoE on the same weights and prompts.
    Returns the main path's launches and the report."""
    on_card = device != "cpu"
    whole = get_config(RAGGED_ARCH)
    cfg, b, s, gen = whole, ZOO_BATCH, ZOO_PROMPT, ZOO_GEN
    if rehearsal:
        cfg, b, s, gen = whole.reduced(), 2, 70, 4
    ragged = replace(cfg, moe_impl="ragged")
    generator = torch.Generator(device=device).manual_seed(seed)
    params = transformer.init_params(generator, cfg, device=device)
    tokens = torch.randint(0, cfg.true_vocab_size, (b, s), generator=generator, device=device)
    impl = fa.make_attn_impl(window=cfg.sliding_window)
    serve.generate(params, tokens[:1, :64], ragged, gen=2, attn_impl=impl)    # warm-up
    log(f"[ragged] {cfg.name}: {cfg.num_layers}/{whole.num_layers} layers, {cfg.num_experts} "
        f"experts top-{cfg.top_k}, d_model {cfg.d_model}, d_ff {cfg.d_ff}; B={b}, prompt {s}, "
        f"{gen} steps, moe_impl='ragged' against 'dense'")

    runs = {}
    for name, run_cfg in (("ragged", ragged), ("dense", cfg)):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels_lib.reset_launch_counts()       # the main path: the ragged run
        res = serve.generate(params, tokens, run_cfg, gen=gen, attn_impl=impl)
        runs[name] = (res, _ragged_launches(),
                      torch.cuda.max_memory_allocated() / 2**20 if on_card else None)
    (rg, launches, peak_r), (dn, dense_launches, peak_d) = runs["ragged"], runs["dense"]
    err = _max_err(rg.prefill_logits, dn.prefill_logits)
    same = bool(torch.equal(rg.tokens, dn.tokens))
    report = {"arch": cfg.name, "layers": cfg.num_layers, "batch": b, "prompt": s, "gen": gen,
              "prefill_s": {"ragged": rg.prefill_s, "dense": dn.prefill_s},
              "decode_ms_per_token": {"ragged": rg.decode_s / gen * 1e3,
                                      "dense": dn.decode_s / gen * 1e3},
              "peak_device_memory_mb": {"ragged": peak_r, "dense": peak_d},
              "prefill_logits_max_abs_diff": err, "same_tokens": same,
              "launches": launches, "dense_launches": dense_launches}
    check(bool(torch.isfinite(rg.prefill_logits).all()) and rg.tokens.shape == (b, gen),
          f"{cfg.name} ragged generate: finite logits, {gen} tokens per prompt")
    check(err <= 1e-3, f"{cfg.name} ragged vs dense prefill logits: max diff {err:.2e} "
          "(atol 1e-3)")
    check(same, f"{cfg.name} ragged and dense greedy tokens equal: {same}")
    if on_card:
        want = 3 * cfg.num_layers * (1 + gen)
        check(launches == {"grouped_mm": want, "grouped_mm_wgrad": 0}
              and dense_launches["grouped_mm"] == 0,
              f"{cfg.name} ragged: grouped_mm launched {launches['grouped_mm']} times = 3 "
              f"products x {cfg.num_layers} layers x (prefill + {gen} steps) = {want}; the "
              f"dense run {dense_launches['grouped_mm']}")
    del params, runs, rg, dn
    if on_card:
        torch.cuda.empty_cache()
    log(f"[ragged] {json.dumps(report)}")
    return launches, report


RAGGED_GRAD_RTOL = 1e-3       # of each leaf's largest |gradient|; a wrong product is O(1)


def _routing(ids: list, forced: list | None = None):
    """``moe.router_topk`` that appends each call's top-k ids to ``ids``. With
    ``forced``, call i takes ``forced[i]`` for its ids: the weights gathered
    from its own softmax and renormalised, the aux loss from those ids, as
    ``router_topk`` computes them from its own."""
    real = moe_lib.router_topk

    def router(logits, top_k):
        weights, idx, aux = real(logits, top_k)
        if forced is not None:
            idx = forced[len(ids)]
            probs = torch.softmax(logits.float(), dim=-1)
            weights = probs.gather(-1, idx)
            weights = (weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)).to(
                logits.dtype)
            e = logits.shape[-1]
            aux = e * torch.sum(F.one_hot(idx, e).float().sum(dim=1).mean(dim=0)
                                * probs.mean(dim=0))
        ids.append(idx)
        return weights, idx, aux
    return router


def _leaf_diffs(got: dict, want: dict) -> dict:
    """Each leaf's max |diff| over its largest |want|; the worst leaf, the MoE
    leaves' and the embedding's; the entries whose sign differs, and the
    largest such |want| over its leaf's scale."""
    rel, flips, flip_max = {}, 0, 0.0
    for name, g in got.items():
        w = want[name]
        scale = float(w.abs().max())
        rel[name] = float((g - w).abs().max()) / scale if scale > 0 else 0.0
        flip = g.sign() != w.sign()
        flips += int(flip.sum())
        if scale > 0 and bool(flip.any()):
            flip_max = max(flip_max, float(w[flip].abs().max()) / scale)
    worst = max(rel, key=rel.get)
    return {"worst_leaf": worst, "worst_rel_diff": rel[worst],
            "moe_rel_diff": max(v for n, v in rel.items() if "/moe/" in n),
            "embed_rel_diff": rel["embed"], "sign_flips": flips,
            "entries": sum(g.numel() for g in got.values()), "largest_flipped_rel": flip_max}


def check_ragged_grads(cfg, v: int, b: int, s: int, seed: int, device: str) -> dict:
    """Vehicle 0's gradients of ``lm_loss`` from the train runs' shared init
    and on their round-1 tokens, through the ragged MoE (the kernels'
    backward: the transposed ``grouped_mm`` and ``grouped_mm_wgrad``) and the
    dense one. The top-k is discrete: where two experts' router logits are
    within rounding of each other, the two paths' f32 sums can pick
    different experts for a token from the second layer on, and that token's
    gradient then differs by O(1) in the experts it reached. So the dense run
    is made twice: routing itself (the layers and tokens whose expert set
    differs, and the gradients' distance, are read, not held) and routing as
    the ragged run did (``_routing``), which is held to ``RAGGED_GRAD_RTOL``
    on every leaf. No remat: each layer's router runs once, in order."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params, _, _ = steps.init_train_state(cfg, v, gen, device=device)
    tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen, device=device)
    leaves = {name: leaf[0].detach().requires_grad_()
              for name, leaf in steps.flatten(params).items()}
    del params

    def grads_of(impl: str, ids: list, forced: list | None = None) -> dict:
        real = moe_lib.router_topk
        moe_lib.router_topk = _routing(ids, forced)
        try:
            loss = transformer.lm_loss(steps.unflatten(leaves), tokens[0],
                                       replace(cfg, moe_impl=impl), remat=False)
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        finally:
            moe_lib.router_topk = real

    ragged_ids, dense_ids = [], []
    ragged = grads_of("ragged", ragged_ids)
    own = _leaf_diffs(ragged, grads_of("dense", dense_ids))
    differs = [int((a.sort(dim=-1).values != d.sort(dim=-1).values).any(dim=-1).sum())
               for a, d in zip(ragged_ids, dense_ids)]
    own["routing_differs"] = {"token_layers": sum(differs), "of": sum(map(len, ragged_ids)),
                              "per_layer": differs}
    same = _leaf_diffs(ragged, grads_of("dense", [], forced=ragged_ids))
    report = {"own_routing": own, "same_routing": same, "rtol": RAGGED_GRAD_RTOL}
    log(f"  vehicle 0's gradients, ragged vs dense routing itself: worst leaf "
        f"{own['worst_leaf']} {own['worst_rel_diff']:.2e}, MoE {own['moe_rel_diff']:.2e}, embed "
        f"{own['embed_rel_diff']:.2e}; expert sets differ at {sum(differs)} of "
        f"{own['routing_differs']['of']} (token, layer) pairs, per layer {differs}")
    check(same["worst_rel_diff"] <= RAGGED_GRAD_RTOL,
          f"{cfg.name} vehicle 0's gradients from the shared init, ragged vs dense routed as "
          f"the ragged run: worst leaf {same['worst_leaf']} {same['worst_rel_diff']:.2e}, MoE "
          f"leaves {same['moe_rel_diff']:.2e}, embed {same['embed_rel_diff']:.2e} of the "
          f"leaf's largest |gradient| (<= {RAGGED_GRAD_RTOL:g}); {same['sign_flips']} of "
          f"{same['entries']} entries differ in sign, the largest of them "
          f"{same['largest_flipped_rel']:.2e} of its leaf's scale")
    del leaves, ragged, tokens
    if device != "cpu":
        torch.cuda.empty_cache()
    return report


def drive_ragged_train(device: str, seed: int, rehearsal: bool) -> tuple[dict, dict]:
    """granite-moe-1b-a400m at full width through ``steps.build_dds_train_step``,
    V=2, B=2 x 1,024, E=1, TRAIN_ROUNDS rounds with ``moe_impl="ragged"`` (the
    main path: the kernels forward and backward) and then with the dense MoE,
    each from the same seeded init and tokens; first ``check_ragged_grads``
    on that init. Returns the ragged run's launches and the report."""
    on_card = device != "cpu"
    whole = get_config(RAGGED_ARCH)
    cfg, v, b, s = whole, TRAIN_V, TRAIN_B, TRAIN_S
    if rehearsal:
        cfg, s = whole.reduced(), 32
    contact = train_cli.ring_contact(v, device)
    target = torch.full((v,), 1.0 / v, device=device)
    grads = check_ragged_grads(cfg, v, b, s, seed, device)
    out, after_round1 = {}, {}
    for impl in ("ragged", "dense"):
        run_cfg = replace(cfg, moe_impl=impl)
        gen = torch.Generator(device=device).manual_seed(seed)
        params, opt, sm = steps.init_train_state(run_cfg, v, gen, device=device)
        ts = steps.build_dds_train_step(run_cfg, lr=TRAIN_LR, p1_steps=TRAIN_P1)
        probe = _probe(params)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels_lib.reset_launch_counts()
        history = []
        for _ in range(TRAIN_ROUNDS):
            tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen,
                                   device=device)
            t0 = time.perf_counter()
            params, opt, sm, metrics = ts.fn(params, opt, sm, tokens, contact, target)
            history.append({**{k: float(x) for k, x in metrics.items()},   # waits for the round
                            "seconds": time.perf_counter() - t0})
            if len(history) == 1:
                after_round1[impl] = _probe(params)
        out[impl] = _train_report(run_cfg, whole, v, b, s, history, _ragged_launches(),
                                  on_card, moe_impl=impl)
        _round_checks(f"{run_cfg.name} ({impl})", history, sm, _moved(params, probe))
        del params, opt, sm, ts
        if on_card:
            torch.cuda.empty_cache()
    launches = {k: out["ragged"][k] for k in ("grouped_mm", "grouped_mm_wgrad")}
    if on_card:
        check(fa.kernel.launch_counts["flash_train_fwd"] == 0,
              f"{cfg.name} f32 rounds: no flash_train launch (f32 attends through _sdpa)")
    loss_r, loss_d = out["ragged"]["loss"][0], out["dense"]["loss"][0]
    check(abs(loss_r - loss_d) <= 1e-4 * abs(loss_d),
          f"{cfg.name} round 1 loss, ragged {loss_r:.6f} vs dense {loss_d:.6f} (rtol 1e-4)")
    if on_card:
        products = 3 * cfg.num_layers * v * TRAIN_ROUNDS     # one per product, vehicle, step
        check(launches["grouped_mm_wgrad"] == products and launches["grouped_mm"] >= 2 * products
              and out["dense"]["grouped_mm"] == 0,
              f"{cfg.name} ragged rounds: grouped_mm_wgrad launched "
              f"{launches['grouped_mm_wgrad']} times = 3 products x {cfg.num_layers} layers x "
              f"{v} vehicles x {TRAIN_ROUNDS} rounds; grouped_mm {launches['grouped_mm']} "
              "(forward, remat's recompute, input gradient)")
    # round 1's parameter change, ragged against dense, in units of the lr
    # (read on the first 4,096 entries of every leaf, as ``_moved``)
    step_diff = max(_max_err(after_round1["ragged"][n], p)
                    for n, p in after_round1["dense"].items()) / TRAIN_LR
    report = {"ragged": out["ragged"], "dense": out["dense"], "gradients": grads,
              "round1_update_max_diff_in_lr": step_diff}
    log(f"[ragged] train {json.dumps(report)}")
    return launches, report


class _dtype_tally:
    """Counts the grouped kernels' launches by dtype while it is entered (the
    custom ops call ``kernel.grouped_mm`` / ``kernel.grouped_mm_wgrad``
    through the module, so wrapping them there sees every launch)."""

    NAMES = ("grouped_mm", "grouped_mm_wgrad")

    def __enter__(self):
        self.counts, self.real = {}, {n: getattr(gmm.kernel, n) for n in self.NAMES}
        for name, fn in self.real.items():
            def counted(x, *args, _fn=fn, _name=name, **kw):
                key = f"{_name}/{str(x.dtype).replace('torch.', '')}"
                self.counts[key] = self.counts.get(key, 0) + 1
                return _fn(x, *args, **kw)
            setattr(gmm.kernel, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(gmm.kernel, name, fn)


def drive_opt_ragged_train(device: str, seed: int, rehearsal: bool,
                           f32_loss: float) -> tuple[dict, dict]:
    """granite-moe-1b-a400m at full width under the ``opt_ragged`` variant
    (``launch.variants``: bf16 compute on the f32 master weights, the bf16
    gossip payload, the ragged MoE): the path on which the bf16 grouped kernels
    lie. V=2, B=2 x 1,024, E=1, TRAIN_ROUNDS rounds through
    ``steps.build_dds_train_step`` from the f32 ragged run's init and tokens
    (the same seed): launch counts per dtype, finite losses, round 1's loss
    within OPT_RAGGED_LOSS_RTOL of ``f32_loss``, s/round and peak memory."""
    on_card = device != "cpu"
    whole = get_config(RAGGED_ARCH)
    cfg, v, b, s = whole, TRAIN_V, TRAIN_B, TRAIN_S
    if rehearsal:
        cfg, s = whole.reduced(), 32
    run_cfg, overrides = variants.apply_variant("opt_ragged", cfg, "train")
    contact = train_cli.ring_contact(v, device)
    target = torch.full((v,), 1.0 / v, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, opt, sm = steps.init_train_state(run_cfg, v, gen, device=device)
    ts = steps.build_dds_train_step(run_cfg, lr=TRAIN_LR, p1_steps=TRAIN_P1, **overrides)
    probe = _probe(params)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    history = []
    with _dtype_tally() as tally:
        for _ in range(TRAIN_ROUNDS):
            tokens = torch.randint(0, cfg.true_vocab_size, (v, b, s), generator=gen,
                                   device=device)
            t0 = time.perf_counter()
            params, opt, sm, metrics = ts.fn(params, opt, sm, tokens, contact, target)
            history.append({**{k: float(x) for k, x in metrics.items()},
                            "seconds": time.perf_counter() - t0})
    report = _train_report(run_cfg, whole, v, b, s, history, _ragged_launches(), on_card,
                           variant="opt_ragged", compute_dtype=str(overrides["compute_dtype"]),
                           launches_by_dtype=tally.counts,
                           round1_loss_f32_ragged=f32_loss, loss_rtol=OPT_RAGGED_LOSS_RTOL)
    _round_checks(f"{run_cfg.name} (opt_ragged)", history, sm, _moved(params, probe))
    loss = history[0]["loss"]
    check(abs(loss - f32_loss) <= OPT_RAGGED_LOSS_RTOL * abs(f32_loss),
          f"{cfg.name} opt_ragged round 1 loss {loss:.6f} vs the f32 ragged run's "
          f"{f32_loss:.6f}: {abs(loss - f32_loss) / abs(f32_loss):.2e} relative "
          f"(rtol {OPT_RAGGED_LOSS_RTOL:g})")
    launches = {k: report[k] for k in ("grouped_mm", "grouped_mm_wgrad")}
    attn = {k: fa.kernel.launch_counts[k]
            for k in ("flash_train_fwd", "flash_train_dq", "flash_train_dkdv")}
    report["flash_train_launches"] = attn
    launches["flash_train_fwd"], launches["flash_train_bwd"] = (attn["flash_train_fwd"],
                                                                attn["flash_train_dq"])
    launches["adamw"] = report["adamw_launches"] = adamw_lib.kernel.launch_counts["adamw"]
    if on_card:
        _check_adamw_launches(f"{cfg.name} opt_ragged rounds", params, v, TRAIN_ROUNDS,
                              launches["adamw"])
        passes = cfg.num_layers * v * TRAIN_ROUNDS
        check(attn == {"flash_train_fwd": 2 * passes, "flash_train_dq": passes,
                       "flash_train_dkdv": passes},
              f"{cfg.name} opt_ragged rounds: the training attention launched {attn} "
              f"(forward and remat's recompute: 2 x {cfg.num_layers} layers x {v} vehicles x "
              f"{TRAIN_ROUNDS} rounds; each backward kernel half that)")
        products = 3 * cfg.num_layers * v * TRAIN_ROUNDS
        check(tally.counts.get("grouped_mm_wgrad/bfloat16", 0) == products
              == launches["grouped_mm_wgrad"]
              and tally.counts.get("grouped_mm/bfloat16", 0) == launches["grouped_mm"]
              >= 2 * products,
              f"{cfg.name} opt_ragged rounds: the bf16 kernels launched {tally.counts} "
              f"(grouped_mm_wgrad = 3 products x {cfg.num_layers} layers x {v} vehicles x "
              f"{TRAIN_ROUNDS} rounds = {products}; grouped_mm at least twice that)")
    del params, opt, sm, ts
    if on_card:
        torch.cuda.empty_cache()
    log(f"[ragged] opt_ragged {json.dumps(report)}")
    return launches, report


def drive_ragged(device: str, seed: int, rehearsal: bool) -> tuple[dict, dict]:
    """The ragged phase's three main paths: serving, the f32 rounds and the
    opt_ragged rounds. Returns their launches, summed, and the report."""
    t0 = time.perf_counter()
    serve_launches, serve_report = drive_ragged_serve(device, seed, rehearsal)
    train_launches, train_report = drive_ragged_train(device, seed, rehearsal)
    opt_launches, opt_report = drive_opt_ragged_train(device, seed, rehearsal,
                                                      train_report["ragged"]["loss"][0])
    launches = {k: serve_launches.get(k, 0) + train_launches.get(k, 0) + opt_launches[k]
                for k in opt_launches}
    log(f"[ragged] phase took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches, {"serve": serve_report, "train": train_report, "opt_ragged": opt_report}


# ---------------------------------------------------------------- examples ----

EXAMPLES = ("torch_quickstart.py", "torch_scenario_sweep.py", "torch_multiarch_dfl.py",
            "torch_vehicular_mnist_e2e.py", "torch_serve_batched.py")


def drive_examples(device: str) -> dict:
    """Each torch example with ``--smoke`` on ``device`` as a subprocess, as a
    user starts it; a non-zero exit or a missing ``OK`` line fails the run."""
    root = Path(__file__).resolve().parent
    seconds = {}
    for script in EXAMPLES:
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, str(root / "examples" / script), "--smoke",
                              "--device", device], capture_output=True, text=True, cwd=root,
                             timeout=600)
        seconds[script] = time.perf_counter() - t0
        ok = [line for line in run.stdout.splitlines() if " OK" in line]
        check(run.returncode == 0 and bool(ok),
              f"examples/{script} --smoke --device {device}: exit {run.returncode}, "
              f"{ok[-1] if ok else run.stderr[-1500:]} ({seconds[script]:.1f} s)")
    return seconds


# --------------------------------------------------------------- main path ----

def drive_main_path(cfg: SimulationConfig, dataset):
    """One run of ``cfg.algorithm`` through the public entry points, every
    counter zeroed just before and read just after. Returns (result, context,
    gossip-mix launches, report)."""
    timer = PhaseTimer(cfg.device)
    ctx = engine.build_context(cfg, dataset=dataset, timer=timer)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels_lib.reset_launch_counts()
    kl_solver.reset_solve_counts()
    t0 = time.perf_counter()
    result = engine.run_with_context(ctx)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernel.launch_counts)
    p1_route = {"eg_solve": kl_simplex.kernel.launch_counts["eg_solve"],
                **{f"{r}_solves": n for r, n in kl_solver.solve_counts.items()}}
    phases = timer.totals_ms()
    report = {
        "algorithm": cfg.algorithm, "contact_format": cfg.contact_format,
        "epochs": cfg.epochs,
        "d_max": ctx.contacts.d_max,
        "seconds_per_epoch": seconds / cfg.epochs,
        "device_ms_per_epoch": {n: v / cfg.epochs for n, v in sorted(phases.items())},
        "peak_device_memory_mb": (torch.cuda.max_memory_allocated() / 2**20
                                  if torch.cuda.is_available() else None),
        "launches": launches, "p1_route": p1_route,
        "avg_accuracy": result.avg_accuracy, "kl_trace": result.kl_trace,
    }
    log(f"  {json.dumps(report)}")

    k = ctx.total_nodes
    check(len(result.kl_trace) == cfg.epochs and len(result.comm_mb) == cfg.epochs,
          "one kl_trace / comm_mb entry per epoch")
    traces = [result.kl_trace, result.comm_mb, result.avg_accuracy,
              result.consensus_distance, np.stack(result.entropy),
              np.stack(result.kl_divergence), np.stack(result.vehicle_accuracy)]
    check(all(np.isfinite(np.asarray(t)).all() for t in traces), "every trace is finite")
    check(len(result.epochs_evaluated) >= 2 and result.entropy[0].shape == (k,),
          f"evaluated at epochs {result.epochs_evaluated}, [K]-shaped diagnostics")
    rows = ctx.final_state.state_matrix.sum(dim=1)
    check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-5)),
          "state-matrix rows sum to 1")
    if cfg.algorithm == "dds":
        check(result.kl_trace[-1] < result.kl_trace[0],
              f"kl_trace falls: {result.kl_trace[0]:.4f} -> {result.kl_trace[-1]:.4f}")
    check(sum(result.comm_mb) > 0, "vehicles exchanged models")
    if cfg.device != "cpu":
        used = "gossip_mix_gather" if cfg.contact_format == "sparse" else "gossip_mix_matmul"
        other = next(n for n in launches if n != used)
        check(launches[used] == cfg.epochs and launches[other] == 0,
              f"{cfg.algorithm} {cfg.contact_format}: {used} launched {launches[used]} "
              f"times = {cfg.epochs} mixes x 1 grouped launch over {len(LEAF_WIDTHS)} "
              f"leaves; {other} {launches[other]} times")
        solves = cfg.epochs if cfg.algorithm == "dds" else 0
        check(p1_route == {"eg_solve": solves, "kernel_solves": solves, "eager_solves": 0},
              f"{cfg.algorithm} {cfg.contact_format}: P1 {p1_route}: {solves} eg_solve "
              "launches, one per round, no eager solve")
    return result, ctx, launches, report


def check_kernel_path_against_torch_mix(ctx, contacts_t) -> None:
    """One more round from the run's final state, same batches, dropout off,
    once through the CUDA-kernel mix and twice through the plain-torch mix.
    The mixed parameters and the state matrix must agree to 1e-5. The
    parameters AFTER the E local steps are reported beside the difference
    between the two identical torch rounds: the backward pass sums with
    atomics in an order that changes from run to run, so that pair is the
    floor any comparison after training sits on."""
    cfg = ctx.cfg
    batch = ctx.sample_fn(ctx.fed_data, ctx.init_rng)
    outs = []
    for mix_fn in (ops.mix_params_cuda, aggregation.mix_params, aggregation.mix_params):
        state, diags = dfl_dds.dds_round(
            ctx.final_state, contacts_t, ctx.target, batch, None,
            ctx.setup.local_train_fn, lr=cfg.lr, local_steps=cfg.local_steps,
            p1_steps=cfg.p1_steps, p1_step_size=cfg.p1_step_size,
            mix_params_fn=mix_fn, local_mask=ctx.local_mask)
        outs.append((state, mix_fn(diags["mixing"], ctx.final_state.params)))
    (a, mixed_a), (b, mixed_b), (c, _) = outs
    err_mix = max(_max_err(mixed_a[n], mixed_b[n]) for n in mixed_a)
    err_state = _max_err(a.state_matrix, b.state_matrix)
    err_par = max(_max_err(a.params[n], b.params[n]) for n in a.params)
    floor = max(_max_err(b.params[n], c.params[n]) for n in b.params)
    check(err_mix <= 1e-5 and err_state <= 1e-5,
          f"{cfg.contact_format}: kernel mix vs torch mix — mixed params {err_mix:.2e}, "
          f"state matrix {err_state:.2e} (atol 1e-5)")
    log(f"  note: after the {cfg.local_steps} local steps the two paths' parameters differ "
        f"by {err_par:.2e}; two identical torch-mix rounds differ by {floor:.2e}")


def check_card_against_cpu(device: str, algorithms=("dds", "sp", "d_sgd")) -> None:
    """The same small federation (an RSU, dropped exchanges) on the card and
    on the CPU, per algorithm and contact format: the traces that do not
    depend on SGD noise agree to 1e-5."""
    ds = synthetic_mnist(n_train=1200, n_test=200)
    runs = [(algo, fmt) for algo in algorithms for fmt in ("sparse", "dense")]
    for algo, fmt in runs:
        base = dict(algorithm=algo, num_vehicles=8, epochs=4, eval_every=2,
                    eval_samples=200, local_steps=2, batch_size=16, p1_steps=40,
                    comm_range=250.0, num_rsus=1, p_drop=0.1)
        on_cpu = run_simulation(SimulationConfig(**base, contact_format=fmt, device="cpu"),
                                dataset=ds)
        on_card = run_simulation(SimulationConfig(**base, contact_format=fmt, device=device),
                                 dataset=ds)
        err = max(np.abs(np.asarray(on_cpu.kl_trace) - np.asarray(on_card.kl_trace)).max(),
                  np.abs(np.stack(on_cpu.entropy) - np.stack(on_card.entropy)).max(),
                  np.abs(np.asarray(on_cpu.comm_mb) - np.asarray(on_card.comm_mb)).max())
        check(err <= 1e-5, f"{algo} {fmt}: small federation, {device} vs cpu traces "
              f"max diff {err:.2e}")


def time_seed_kernels(device, mixing_sparse, mixing_dense) -> dict[str, dict]:
    """Times of one round's mix with the seed axis: S seeds x the model's 8
    leaves in one launch, gather or matmul; plain versions and library calls
    per leaf (the library's sparse product over the block-diagonal ``[S*K,
    S*K]`` CSR of the seeds' weights, which stores only the real slots)."""
    seeds, k = mixing_dense.shape[:2]
    r = np.random.default_rng(1)
    leaves = [torch.as_tensor(r.normal(size=(seeds, k, p)).astype(np.float32)).to(device)
              for p in LEAF_WIDTHS]
    folded = [x.reshape(seeds * k, -1) for x in leaves]
    idx = mixing_sparse.idx.to(torch.int32).contiguous()
    w = mixing_sparse.w.contiguous()
    nnz = int((w != 0).sum())
    d = idx.shape[-1]
    csr = torch.block_diag(*mixing_dense).to_sparse_csr()
    model_bytes = sum(2 * seeds * k * p * 4 for p in LEAF_WIDTHS)
    specs = {
        "gossip_mix_gather": dict(
            round=lambda: kernel.gossip_mix_gather_grouped(idx, w, leaves),
            plain=lambda: [ref.gossip_mix_gather_ref(idx, w, x) for x in leaves],
            library=lambda: [torch.sparse.mm(csr, x) for x in folded],
            bytes=model_bytes + seeds * k * d * 8,
            flops=2 * nnz * sum(LEAF_WIDTHS),
            work=f"one round's mix of S={seeds} seeds: 1 grouped launch over "
                 f"{len(leaves)} leaves [S, K={k}, P], D={d}, {nnz} real slots; "
                 f"library_ms: {len(leaves)} torch.sparse.mm calls (block-diagonal CSR)"),
        "gossip_mix_matmul": dict(
            round=lambda: kernel.gossip_mix_matmul_grouped(mixing_dense, leaves),
            plain=lambda: [ref.gossip_mix_matmul_ref(mixing_dense, x) for x in leaves],
            library=lambda: [torch.matmul(mixing_dense, x) for x in leaves],
            bytes=model_bytes + seeds * k * k * 4,
            flops=2 * seeds * k * k * sum(LEAF_WIDTHS),
            work=f"one round's mix of S={seeds} seeds: 1 grouped launch over "
                 f"{len(leaves)} leaves [S, K={k}, P], W [S, K, K]; library_ms: "
                 f"{len(leaves)} batched torch.matmul calls"),
    }
    out = {}
    for name, spec in specs.items():
        out[name] = {"seeds": seeds, **_timed(spec["round"], spec["plain"], spec["library"],
                                              spec["bytes"], spec["flops"], spec["work"])}
        log(f"  {name} seed axis: {json.dumps(out[name])}")
    return out


# ---------------------------------------------------------------- seeds ----

def _seconds_of(fn, device: str) -> tuple[float, object]:
    """Host seconds of ``fn()`` with the card drained before and after."""
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def drive_seeds(full: SimulationConfig, dataset) -> tuple[dict, dict]:
    """``engine.run_seeds`` of S=len(SEEDS) ``dds`` federations at full
    width, per contact format and under delayed gossip (sparse), each after a
    one-epoch warm-up; the counters zeroed just before each batch and read
    just after. Every seed's deterministic traces are held to a single run of
    that seed on the card. Returns the report and the mix launches per
    kernel (summed over the three batches)."""
    device = full.device
    on_card = device != "cpu"
    report, launches = {}, {}
    for fmt, overlap in (("sparse", "sync"), ("dense", "sync"), ("sparse", "delayed")):
        cfg = replace(full, contact_format=fmt, overlap=overlap)
        log(f"[seeds] run_seeds S={len(SEEDS)}, contact_format={fmt}, overlap={overlap}")
        engine.run_seeds(replace(cfg, epochs=1), SEEDS, dataset=dataset)
        setup_s, _ = _seconds_of(lambda: [engine.build_context(replace(cfg, seed=s),
                                                               dataset=dataset)
                                          for s in SEEDS], device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        kernels_lib.reset_launch_counts()
        batch_s, batch = _seconds_of(lambda: engine.run_seeds(cfg, SEEDS, dataset=dataset),
                                     device)
        counts = dict(kernel.launch_counts)
        peak_batch = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
        used = "gossip_mix_gather" if fmt == "sparse" else "gossip_mix_matmul"
        other = next(n for n in counts if n != used)
        if on_card:
            check(counts[used] == cfg.epochs and counts[other] == 0,
                  f"run_seeds {fmt}/{overlap}: {used} launched {counts[used]} times = "
                  f"{cfg.epochs} rounds x 1 launch for all {len(SEEDS)} seeds "
                  f"(not {cfg.epochs * len(SEEDS)}); {other} {counts[other]} times")
        launches[used] = launches.get(used, 0) + counts[used]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        singles_s, worst = 0.0, 0.0
        for seed, res in zip(SEEDS, batch):
            traces = [res.kl_trace, res.comm_mb, res.avg_accuracy, res.consensus_distance,
                      np.stack(res.entropy), np.stack(res.vehicle_accuracy)]
            check(all(np.isfinite(np.asarray(t)).all() for t in traces)
                  and len(res.kl_trace) == cfg.epochs,
                  f"seed {seed}: every trace of the batch is finite")
            t, single = _seconds_of(
                lambda: run_simulation(replace(cfg, seed=seed), dataset=dataset), device)
            singles_s += t
            diffs = {f: float(np.abs(np.asarray(getattr(res, f), np.float64)
                                     - np.asarray(getattr(single, f), np.float64)).max())
                     for f in ("kl_divergence", "entropy", "comm_mb", "kl_trace")}
            err = max(diffs.values())
            check(err <= 1e-5 and res.epochs_evaluated == single.epochs_evaluated,
                  f"seed {seed} {fmt}/{overlap}: batch vs single run, max diff "
                  + ", ".join(f"{f} {v:.2e}" for f, v in diffs.items()) + " (atol 1e-5)")
            worst = max(worst, float(err))
        peak_single = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
        report[f"{fmt}/{overlap}"] = {
            "seeds": len(SEEDS), "epochs": cfg.epochs,
            "setup_s_3_contexts": setup_s,
            "batch_s_per_epoch_incl_setup": batch_s / cfg.epochs,
            "batch_s_per_epoch": (batch_s - setup_s) / cfg.epochs,
            "three_singles_s_per_epoch_incl_setup": singles_s / cfg.epochs,
            "three_singles_s_per_epoch": (singles_s - setup_s) / cfg.epochs,
            "peak_device_memory_mb_batch": peak_batch,
            "peak_device_memory_mb_single": peak_single,
            "launches": counts, "max_diff_vs_single": worst,
            "final_accuracy": [r.final_accuracy() for r in batch]}
        log(f"  {json.dumps(report[f'{fmt}/{overlap}'])}")
    return report, launches


def check_delayed_anchor(full: SimulationConfig) -> None:
    """The reference's anchor: with W = I the delayed mix is the sync mix bit
    for bit. (a) Through the mix entry point at full width, S seeds, both
    formats: the identity mixing over random params and a random stale
    buffer. (b) End to end at a small size (p_drop = 1, so every W is I),
    single runs and run_seeds: the deterministic traces bit for bit; the
    accuracies within the run-to-run floor of two identical sync runs (the
    card's backward pass sums with atomics; on the CPU the floor is 0)."""
    device = full.device
    seeds, k = len(SEEDS), full.num_vehicles
    r = np.random.default_rng(3)
    params = {f"leaf{i}": torch.as_tensor(r.normal(size=(seeds, k, p)).astype(np.float32))
              .to(device) for i, p in enumerate(LEAF_WIDTHS)}
    stale = {n: torch.as_tensor(r.normal(size=tuple(v.shape)).astype(np.float32)).to(device)
             for n, v in params.items()}
    rows = torch.arange(k, dtype=torch.int32, device=device)
    idx = torch.stack([rows] + [torch.roll(rows, j) for j in (1, 2)], dim=-1)
    idx = idx.expand(seeds, k, 3).contiguous()
    w = torch.zeros(seeds, k, 3, device=device)
    w[..., 0] = 1.0
    eye = torch.eye(k, device=device).expand(seeds, k, k).contiguous()
    delayed = vehicle_axis.delayed_gossip_mix(ops.mix_params_cuda)
    for what, mixing in (("sparse", contacts_lib.SparseMixing(idx, w)), ("dense", eye)):
        kernels_lib.reset_launch_counts()
        got = delayed(mixing, params, stale)
        want = ops.mix_params_cuda(mixing, params)
        exact = all(torch.equal(got[n], want[n]) and torch.equal(want[n], params[n])
                    for n in params)
        n_launch = sum(kernel.launch_counts.values())
        check(exact and (n_launch == 2 or device == "cpu"),
              f"delayed anchor, {what}, W = I: delayed mix == sync mix == params bit for "
              f"bit, S={seeds}, K={k}, {n_launch} kernel launches")
    base = replace(full, num_vehicles=8, epochs=4, eval_every=2, local_steps=2,
                   batch_size=16, p1_steps=40, eval_samples=200, p_drop=1.0)
    small = synthetic_mnist(n_train=1200, n_test=200)
    sync_a = run_simulation(base, dataset=small)
    sync_b = run_simulation(base, dataset=small)
    late = run_simulation(replace(base, overlap="delayed"), dataset=small)
    floor = float(np.abs(np.asarray(sync_a.avg_accuracy) - np.asarray(sync_b.avg_accuracy)).max())
    diff = float(np.abs(np.asarray(sync_a.avg_accuracy) - np.asarray(late.avg_accuracy)).max())
    same = (late.kl_trace == sync_a.kl_trace and late.comm_mb == sync_a.comm_mb
            and all(np.array_equal(a, b) for a, b in zip(late.entropy, sync_a.entropy)))
    check(same and diff <= floor,
          f"delayed anchor end to end (K=8, p_drop=1): kl_trace / comm_mb / entropy bit for "
          f"bit; accuracy diff {diff:.2e} within the sync-vs-sync floor {floor:.2e}")
    batch_sync = engine.run_seeds(base, SEEDS, dataset=small)
    batch_late = engine.run_seeds(replace(base, overlap="delayed"), SEEDS, dataset=small)
    same = all(a.kl_trace == b.kl_trace and a.comm_mb == b.comm_mb
               for a, b in zip(batch_sync, batch_late))
    check(same, "delayed anchor through run_seeds: every seed's kl_trace / comm_mb bit for bit")


# --------------------------------------------------------------- sharded ----

def _shard_rank(rank: int, n: int, workdir: str, cfg: dict, transport: str) -> None:
    """One rank of the sharded phase, a process of its own: joins the group,
    loads the kernels the parent built and the dataset the parent wrote, and
    runs each of ``SHARD_RUNS`` through ``run_with_context`` on the
    shard_map backend after a one-epoch warm-up, its launch counters zeroed
    just before and read just after (the dataset is ``dataset.npz`` beside
    ``workdir``). Writes what it saw to
    ``workdir/rank{rank}.pkl``. Nothing is caught: a failure fails the
    spawn, and the parent's join raises."""
    torch.set_num_threads(1)
    mesh_lib.initialize_multihost(init_method=f"file://{workdir}/store", num_processes=n,
                                  process_id=rank, transport=transport,
                                  timeout_s=SHARD_TIMEOUT_S)
    full = SimulationConfig(**cfg)
    on_card = full.device != "cpu"
    if on_card:
        kernels_lib.build_all()                   # loads the parent's build
    with np.load(Path(workdir).parent / "dataset.npz") as arrays:
        dataset = Dataset(train_x=arrays["train_x"], train_y=arrays["train_y"],
                          test_x=arrays["test_x"], test_y=arrays["test_y"],
                          num_classes=int(arrays["num_classes"]), name=str(arrays["name"]))
    run_simulation(replace(full, epochs=1, backend="shard_map"), dataset=dataset)  # warm-up
    out = {}
    for fmt, overlap, bucket_mb in SHARD_RUNS:
        cfg_run = replace(full, backend="shard_map", contact_format=fmt, overlap=overlap,
                          comm_bucket_mb=bucket_mb)
        timer = PhaseTimer(full.device)
        ctx = engine.build_context(cfg_run, dataset=dataset, timer=timer)
        local = [x[:full.num_vehicles // n] for x in ctx.setup.params_stack.values()]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        kernels_lib.reset_launch_counts()
        seconds, result = _seconds_of(lambda: engine.run_with_context(ctx), full.device)
        launches = dict(kernel.launch_counts)
        out[f"{fmt}/{overlap}"] = {
            "result": result, "launches": launches, "comm_bucket_mb": bucket_mb,
            "buckets": len(vehicle_axis.comm_buckets(local, bucket_mb * 2**20)),
            "seconds_per_epoch": seconds / full.epochs,
            "device_ms_per_epoch": {name: v / full.epochs
                                    for name, v in sorted(timer.totals_ms().items())},
            "peak_device_memory_mb": (torch.cuda.max_memory_allocated() / 2**20
                                      if on_card else None)}
    with open(Path(workdir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    mesh_lib.shutdown()


SHARD_FIELDS = ("kl_trace", "comm_mb", "entropy", "kl_divergence")


def drive_sharded(full: SimulationConfig, dataset, vmap_runs: dict) -> tuple[dict, dict]:
    """The shard_map backend at the main path's full width: N = 2 and 4
    ranks (spawned, one process each, all on this card), each running
    ``SHARD_RUNS``. Every rank must return the same result; the state side
    (``kl_trace`` / ``comm_mb`` / ``entropy`` / ``kl_divergence``) must equal
    the vmap run's to 1e-5 and the average accuracy to ``SHARD_ACC_ATOL``;
    each rank launches its mix kernel once per round and bucket. Returns the
    report and the mix launches per kernel (all ranks, all runs)."""
    device = full.device
    transport = "gloo" if device == "cpu" else SHARD_TRANSPORT
    log(f"[sharded] transport: {transport} ({'CPU ranks' if device == 'cpu' else 'N ranks share this one card; collectives staged through host memory'})")
    report, launches = {}, {"gossip_mix_gather": 0, "gossip_mix_matmul": 0}
    # the spread between two correct mixes for scale: the vmap run through the
    # plain-torch mix (another summation order) against the kernel-mix run
    spread = {}
    for fmt, overlap, _ in SHARD_RUNS:
        case = f"{fmt}/{overlap}"
        other = run_simulation(replace(full, contact_format=fmt, overlap=overlap,
                                       mixing_backend="torch"), dataset=dataset)
        want = vmap_runs[case]
        spread[case] = {
            "avg_accuracy": float(np.abs(np.asarray(other.avg_accuracy)
                                         - np.asarray(want.avg_accuracy)).max()),
            "vehicle_accuracy": float(np.abs(np.stack(other.vehicle_accuracy)
                                             - np.stack(want.vehicle_accuracy)).max())}
        log(f"  vmap {case}, torch mix vs kernel mix (two correct mixes): average "
            f"accuracy {spread[case]['avg_accuracy']:.4f}, per-vehicle "
            f"{spread[case]['vehicle_accuracy']:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(Path(tmp) / "dataset.npz", train_x=dataset.train_x, train_y=dataset.train_y,
                 test_x=dataset.test_x, test_y=dataset.test_y,
                 num_classes=dataset.num_classes, name=dataset.name)
        for n in SHARD_COUNTS:
            workdir = Path(tmp) / f"n{n}"
            workdir.mkdir()
            log(f"[sharded] N={n} ranks, runs {[f'{f}/{o}' for f, o, _ in SHARD_RUNS]}")
            t0 = time.perf_counter()
            procs = mp.start_processes(_shard_rank, args=(n, str(workdir), asdict(full),
                                                          transport),
                                       nprocs=n, join=False, start_method="spawn")
            deadline = time.monotonic() + 2 * SHARD_TIMEOUT_S
            while not procs.join(timeout=1):
                if time.monotonic() > deadline:
                    for proc in procs.processes:
                        proc.kill()
                    raise SystemExit(f"FAILED: the {n}-rank sharded phase did not finish")
            wall = time.perf_counter() - t0
            ranks = [pickle.loads((workdir / f"rank{r}.pkl").read_bytes()) for r in range(n)]
            for case, first in ranks[0].items():
                res = first["result"]
                want = vmap_runs[case]
                same = all(np.array_equal(np.asarray(getattr(o[case]["result"], f), float),
                                          np.asarray(getattr(res, f), float))
                           for o in ranks[1:] for f in SHARD_FIELDS + (
                               "avg_accuracy", "vehicle_accuracy", "consensus_distance"))
                check(same, f"N={n} {case}: every rank returns the same result")
                diffs = {f: float(np.abs(np.asarray(getattr(res, f), np.float64)
                                         - np.asarray(getattr(want, f), np.float64)).max())
                         for f in SHARD_FIELDS}
                check(max(diffs.values()) <= 1e-5 and res.epochs_evaluated == want.epochs_evaluated,
                      f"N={n} {case}: sharded vs vmap, "
                      + ", ".join(f"{f} {v:.2e}" for f, v in diffs.items()) + " (atol 1e-5)")
                acc = float(np.abs(np.asarray(res.avg_accuracy) - np.asarray(want.avg_accuracy)).max())
                veh = float(np.abs(np.stack(res.vehicle_accuracy) - np.stack(want.vehicle_accuracy)).max())
                cons = float(np.max(np.abs(np.asarray(res.consensus_distance)
                                           - np.asarray(want.consensus_distance))
                                    / np.abs(np.asarray(want.consensus_distance))))
                check(acc <= SHARD_ACC_ATOL and np.isfinite(res.avg_accuracy).all(),
                      f"N={n} {case}: average accuracy vs vmap max diff {acc:.4f} "
                      f"(tolerance {SHARD_ACC_ATOL}); per-vehicle {veh:.4f}, consensus "
                      f"relative {cons:.2e} (reported)")
                used = "gossip_mix_gather" if case.startswith("sparse") else "gossip_mix_matmul"
                other = next(name for name in launches if name != used)
                for rank, o in enumerate(ranks):
                    check("reduce_scatter" in o[case]["device_ms_per_epoch"],
                          f"N={n} {case} rank {rank}: the sharded mix ran (reduce_scatter "
                          f"{o[case]['device_ms_per_epoch'].get('reduce_scatter', 0):.2f} "
                          "ms/epoch)")
                    got = o[case]["launches"]
                    want_n = full.epochs * o[case]["buckets"]
                    if device != "cpu":
                        check(got[used] == want_n and got[other] == 0,
                              f"N={n} {case} rank {rank}: {used} launched {got[used]} times = "
                              f"{full.epochs} rounds x {o[case]['buckets']} bucket(s) of "
                              f"{o[case]['comm_bucket_mb']} MiB; {other} {got[other]}")
                    launches[used] += got[used]
                report[f"N={n} {case}"] = {
                    "ranks": n, "transport": transport, "epochs": full.epochs,
                    "buckets": first["buckets"], "comm_bucket_mb": first["comm_bucket_mb"],
                    "max_diff_vs_vmap": diffs, "avg_accuracy_diff": acc,
                    "vehicle_accuracy_diff": veh, "consensus_rel_diff": cons,
                    "two_correct_mixes_spread": spread[case],
                    "per_rank": [{"seconds_per_epoch": o[case]["seconds_per_epoch"],
                                  "device_ms_per_epoch": o[case]["device_ms_per_epoch"],
                                  "peak_device_memory_mb": o[case]["peak_device_memory_mb"],
                                  "launches": o[case]["launches"]} for o in ranks]}
                log(f"  {json.dumps(report[f'N={n} {case}'])}")
            log(f"[sharded] N={n}: {wall:.1f} s for the spawn, start-up and warm-up included")
    return report, launches


def drive_campaign(device: str, rehearsal: bool) -> dict:
    """The port's default figure set at the smoke tier, forced, into a store
    in a temporary directory (never the tree). Fails if a scenario raises or
    leaves a non-finite trajectory; the ordering checks are reported, not
    gated on."""
    overrides = dict(num_vehicles=6, epochs=3, p1_steps=10, eval_samples=64) if rehearsal else {}
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "campaign_smoke_torch.jsonl")
        spec = figures_common.campaign_spec("smoke", device=device, store_path=store,
                                            **overrides)
        log(f"[campaign] figures {' '.join(spec.figures)}, K={spec.base.num_vehicles}, "
            f"{spec.base.epochs} epochs, seeds {list(spec.seeds)}, --force, store in a "
            "temporary directory")
        t0 = time.perf_counter()
        results = campaign_lib.run_campaign(spec, force=True)
        wall = time.perf_counter() - t0
        rows = {row["spec_hash"]: row for fr in results for row in fr.scenario_rows}
        for row in rows.values():
            traces = [row["avg_accuracy"], row["kl_trace"], row["comm_mb"],
                      row["consensus_distance"], row["final_accuracy"]]
            check(all(np.isfinite(np.asarray(t, dtype=float)).all() for t in traces),
                  f"campaign scenario {'/'.join(row['key'])}: finite trajectories, "
                  f"{row['wall_time_s']:.1f} s")
        stored = campaign_lib.ResultsStore(store)
        check(len(stored) == len(rows), f"the store holds the {len(rows)} unique scenarios")
        n_checks = sum(len(fr.checks) for fr in results)
        n_passed = sum(c.passed for fr in results for c in fr.checks)
        for fr in results:
            for c in fr.checks:
                log(f"  {'PASS' if c.passed else 'FAIL'} {fr.spec.name}:{c.name} — {c.detail}")
    summary = {"figures": list(spec.figures), "scenarios": len(rows),
               "n_passed": n_passed, "n_checks": n_checks, "wall_s": wall,
               "scenario_wall_s": {"/".join(r["key"]): r["wall_time_s"] for r in rows.values()}}
    log(f"[campaign] {n_passed}/{n_checks} ordering checks passed (not gated), "
        f"{len(rows)} scenarios in {wall:.1f} s")
    log(f"[campaign] {json.dumps(summary)}")
    return summary


# ---------------------------------------------------- P1 entry point ----

def _device_events(fn) -> int | None:
    """Kernels and copies the device ran for one call of ``fn``, counted by
    ``torch.profiler`` (None off the card)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def _seconds(fn):
    """(result, host seconds) of one synchronised call of ``fn``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def _wall_s(fn) -> float:
    return _seconds(fn)[1]


def _plain_p1(cfg: SimulationConfig, states, target, contact_matrix):
    """The P1 loop with the plain EG step on any device: ``ref.eg_iterate``
    over ``eg_step_ref``."""
    return kl_simplex.ref.eg_iterate(states, target, contact_matrix, cfg.p1_steps,
                                     cfg.p1_step_size, kl_simplex.eg_step_ref)


def _check_p1(cfg: SimulationConfig, states, target, contact_matrix, want: str):
    """``core.kl_solver.solve_p1_all`` held to the plain loop by the per-row P1
    objective (atol 1e-5, the criterion of tests/test_kernels.py), alpha on
    the simplex and 0 off the contacts; on the card, exactly one ``eg_solve``
    launch (``want="eg_solve"``) or one ``eg_step`` launch per step
    (``want="eg_step"``) and none of the other. Returns (alpha, the plain
    loop's alpha, the two kernels' launches)."""
    kw = dict(num_steps=cfg.p1_steps, step_size=cfg.p1_step_size)
    eager_alpha = _plain_p1(cfg, states, target, contact_matrix)
    kernels_lib.reset_launch_counts()
    alpha = kl_solver.solve_p1_all(states, target, contact_matrix, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = {n: kl_simplex.kernel.launch_counts[n] for n in ("eg_solve", "eg_step")}
    k = states.shape[0]
    if states.is_cuda:
        expect = ({"eg_solve": 1, "eg_step": 0} if want == "eg_solve"
                  else {"eg_solve": 0, "eg_step": cfg.p1_steps})
        check(launches == expect, f"K={k}: {launches} = {expect}")
    err = _max_err(kl_solver.kl_objective(alpha, states, target),
                   kl_solver.kl_objective(eager_alpha, states, target))
    check(alpha.shape == contact_matrix.shape and err <= 1e-5,
          f"P1 per-row objective vs the plain loop: max diff {err:.2e} "
          f"(K={k}, {cfg.p1_steps} steps, step {cfg.p1_step_size})")
    check(bool((alpha[contact_matrix == 0] == 0).all()), f"K={k}: alpha is 0 off the contacts")
    rows = alpha.sum(dim=1)
    check(bool(torch.allclose(rows, torch.ones_like(rows), atol=1e-5)),
          f"K={k}: every row of alpha sums to 1")
    return alpha, eager_alpha, launches


def _graph_of(fn):
    """``fn`` captured once in a CUDA graph (after a warm-up on a side
    stream); returns the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def check_fused_p1(cfg: SimulationConfig, states, target, contact_matrix,
                   k_past_limit: int, seed: int) -> dict[str, int]:
    """``core.kl_solver.solve_p1_all`` at full width on a real state matrix
    (one ``eg_solve`` launch), then on a seeded K = ``k_past_limit`` problem
    past the one-launch limit (its loop: one ``eg_step`` launch per step),
    both held to the plain loop. Prints, as facts, the wall time and device
    events of the one-launch solve (``one_launch``), of the loop over the
    ``eg_step`` kernel at the same K (``per_step``), of that loop replayed
    from a CUDA graph, and of the plain loop (``eager``). Returns the
    launches of the full-width solve's kernel and of the per-step case's,
    and the facts (None off the card)."""
    alpha, eager_alpha, first = _check_p1(cfg, states, target, contact_matrix, "eg_solve")
    big = _p1_case(k_past_limit, k_past_limit, seed, states.device, empty_row=False)
    if states.is_cuda:
        check(not kl_simplex.kernel.eg_solve_fits(k_past_limit, k_past_limit),
              f"K={k_past_limit} is past eg_solve's limit "
              f"(K <= {kl_simplex.kernel.eg_solve_max_k()})")
    _, _, second = _check_p1(cfg, *big, "eg_step")
    launches = {"eg_solve": first["eg_solve"], "eg_step": second["eg_step"]}
    if not states.is_cuda:
        return launches, None
    s = states.to(torch.float32).contiguous()
    g = target.to(torch.float32).contiguous()
    m = contact_matrix.to(torch.float32).contiguous()
    kw = dict(num_steps=cfg.p1_steps, step_size=cfg.p1_step_size)

    def per_step():
        return kl_simplex.ref.eg_iterate(s, g, m, cfg.p1_steps, cfg.p1_step_size,
                                         kl_simplex.eg_step)

    runs = {
        "one_launch": lambda: kl_solver.solve_p1_all(s, g, m, **kw),
        "per_step": per_step,
        "per_step_cuda_graph_replay": _graph_of(per_step),
        "eager": lambda: _plain_p1(cfg, s, g, m),
    }
    facts = {name: {"wall_s": _wall_s(fn), "device_events": _device_events(fn)}
             for name, fn in runs.items()}
    facts["K"] = states.shape[0]
    facts["one_launch_vs_eager_alpha_max_abs_diff"] = _max_err(alpha, eager_alpha)
    log(f"  facts: {json.dumps(facts)}")
    return launches, facts


# --------------------------------------------------------- baselines ----

def drive_baselines(full: SimulationConfig, dataset) -> tuple[dict, list]:
    """Each baseline at full width through the gossip-mix kernels, both
    contact formats, after a one-epoch warm-up. Returns the seconds per epoch
    by algorithm and format, and per run the final state matrix, target and
    last diagnostics (for the diagnostics phase)."""
    seconds, finals = {}, []
    for algo in BASELINES:
        cfg = replace(full, algorithm=algo, epochs=BASELINE_EPOCHS, eval_every=1)
        run_simulation(replace(cfg, epochs=1), dataset=dataset)
        results = {}
        for fmt in ("sparse", "dense"):
            log(f"[baselines] run_simulation, algorithm={algo}, contact_format={fmt}")
            res, ctx, _, report = drive_main_path(replace(cfg, contact_format=fmt), dataset)
            results[fmt] = res
            seconds.setdefault(algo, {})[fmt] = report["seconds_per_epoch"]
            finals.append(_final_diagnostics(ctx, res))
        sparse, dense = results["sparse"], results["dense"]
        err = max(np.abs(np.asarray(sparse.kl_trace) - np.asarray(dense.kl_trace)).max(),
                  np.abs(np.asarray(sparse.comm_mb) - np.asarray(dense.comm_mb)).max())
        check(err <= 1e-5, f"{algo}: dense and sparse give the same kl_trace / comm_mb "
              f"(max diff {err:.2e})")
    return seconds, finals


def _final_diagnostics(ctx, result) -> tuple:
    return (f"{ctx.cfg.algorithm}/{ctx.cfg.contact_format}",
            ctx.final_state.state_matrix, ctx.target,
            result.kl_divergence[-1], result.entropy[-1])


def check_diagnostics(finals: list, device) -> dict[str, int]:
    """``kl_rows`` / ``entropy_rows`` (the kernels, on the card) on each run's
    final state matrix against that run's last diagnostics, atol 1e-5.
    Returns the launches of the two kernels on this path."""
    kernels_lib.reset_launch_counts()
    for name, states, target, kl_last, entropy_last in finals:
        kl = kl_simplex.kl_rows(states, target).cpu().numpy()
        h = kl_simplex.entropy_rows(states).cpu().numpy()
        err_kl = float(np.abs(kl - kl_last).max())
        err_h = float(np.abs(h - entropy_last).max())
        check(max(err_kl, err_h) <= 1e-5,
              f"{name}: kl_rows / entropy_rows of the final state matrix vs the run's "
              f"last kl_divergence / entropy: {err_kl:.2e} / {err_h:.2e}")
    launches = {n: kl_simplex.kernel.launch_counts[n] for n in ("kl_rows", "entropy_rows")}
    if device != "cpu":
        check(all(c == len(finals) for c in launches.values()),
              f"kl_rows / entropy_rows launched once per final state matrix: {launches}")
    return launches

# --------------------------------------------------------- cost model ----

def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs)


def _contact_stream_s(cfg: SimulationConfig, net) -> float:
    """Host seconds per epoch of ``cfg``'s contact stream (mobility and the
    contact format's packing), one window of ``cfg.epochs`` as a run makes it."""
    stream = engine.ContactStream(cfg, net)
    t0 = time.perf_counter()
    stream.window(cfg.epochs)
    return (time.perf_counter() - t0) / cfg.epochs


def fit_h100_profile(full: SimulationConfig, d_max: int, reports: list, timings: dict,
                     p1_facts: dict, sharded: dict, scale: dict) -> dict:
    """The constants of ``scenario_cost.H100`` as this run measures them:
    from the DDS main path's two runs (``reports``: wall s/epoch and phase
    spans), the kernels line's gather and matmul rows and its id-table
    ``eg_solve`` row at K (the one-launch solve's step), the P1 facts (the
    eager solve's wall time over its device events and over its steps), the
    contact stream timed
    on the host at the main path's K and at the scale workload's (``scale``,
    ``drive_scale_pair``'s report), and the sharded phase (gloo staged
    through host memory, N ranks sharing this card)."""
    stats = scenario_cost.local_train_stats(full.dataset, full.local_steps, full.batch_size)
    k, p = full.num_vehicles + full.num_rsus, stats["params"]
    spans = [r["device_ms_per_epoch"] for r in reports]
    # the model's per-sample forward cost; the eval span per evaluating epoch
    per_sample_fwd = stats["flops"] / (3.0 * full.local_steps * full.batch_size)
    eval_s = _mean(r["device_ms_per_epoch"]["eval"] * r["epochs"] / len(r["avg_accuracy"])
                   for r in reports) / 1e3
    gather, matmul = timings["gossip_mix_gather"], timings["gossip_mix_matmul"]
    eager = p1_facts["eager"]
    net = topology.make_road_network(full.road_net, seed=full.seed)
    contact_s = {fmt: _contact_stream_s(replace(full, contact_format=fmt, d_max=d_max), net)
                 for fmt in ("sparse", "dense")}
    fit = {
        "train_flops_per_s": k * stats["flops"] / (_mean(s["local_train"] for s in spans) / 1e3),
        "eval_flops_per_s": k * full.eval_samples * per_sample_fwd / eval_s,
        "gemm_flops_per_s": 2.0 * k * k * p / (matmul["ms"] / 1e3),
        "gemm_dispatch_s": eager["wall_s"] / eager["device_events"],
        "stream_bytes_per_s": (scenario_cost.MIX_SLOT_BYTES * k * d_max * p
                               / (gather["plain_ms"] / 1e3)),
        "epoch_overhead_s": _mean(r["seconds_per_epoch"]
                                  - sum(r["device_ms_per_epoch"].values()) / 1e3
                                  - contact_s[r["contact_format"]] for r in reports),

        "cuda_mix_gain": gather["plain_ms"] / gather["ms"],
        "p1_step_host_s": eager["wall_s"] / full.p1_steps,
        "p1_kernel_step_s": next(row["ms"] for label, row in timings["eg_solve"]["id_table"].items()
                                 if label.startswith(f"k{k}_sparse")) / 1e3 / full.p1_steps,
    }
    # one reduce-scatter per round at 8 MiB buckets: t(N) = launch + bytes(N) / rate
    # from N = 2 and 4 (the larger N ships more: (N-1)/N of the partials)
    t, b = {}, {}
    for n in SHARD_COUNTS:
        row = sharded[f"N={n} sparse/sync"]
        t[n] = statistics.median(o["device_ms_per_epoch"]["reduce_scatter"]
                                 for o in row["per_rank"]) / 1e3 / row["buckets"]
        b[n] = vehicle_axis.psum_scatter_bytes(k, 4 * p, n)
    n2, n4 = SHARD_COUNTS
    rate = (b[n4] - b[n2]) / (t[n4] - t[n2]) if t[n4] > t[n2] else 0.0
    launch = t[n2] - b[n2] / rate if rate > 0 else -1.0
    if launch < 0:                  # the two points do not separate them
        launch, rate = 0.0, b[n2] / t[n2]
    fit["collective_launch_s"], fit["collective_bytes_per_s"] = launch, rate
    # contact stream per epoch: per vehicle + per pair, from K and the scale K
    k2 = scale["num_vehicles"]
    t1 = _mean(contact_s.values())
    t2 = _mean(scale[fmt]["contact_stream_s_per_epoch"] for fmt in ("sparse", "dense"))
    pair = max(0.0, (t2 / k2 - t1 / k) / (k2 - k))
    fit["contact_host_s_per_vehicle"], fit["contact_host_s_per_pair"] = t1 / k - pair * k, pair
    # Amdahl fraction at N=2: the vmap epoch against a rank's epoch less its
    # collectives (ranks sharing one card: no speedup, clamped at 0)
    row = sharded[f"N={n2} sparse/sync"]
    rank_s = (statistics.median(o["seconds_per_epoch"] for o in row["per_rank"])
              - t[n2] * row["buckets"])
    speedup = reports[0]["seconds_per_epoch"] / rank_s
    fit["shard_parallel_fraction"] = min(1.0, max(0.0, (1 - 1 / speedup) / (1 - 1 / n2)))
    fit["inputs"] = {"p1_s_per_step": {r["contact_format"]: r["device_ms_per_epoch"]["p1_solve"]
                                       / 1e3 / full.p1_steps for r in reports},
                     "reduce_scatter_s": {str(n): t[n] for n in SHARD_COUNTS},
                     "shard_speedup_n2": speedup, "eval_s_per_evaluating_epoch": eval_s,
                     "contact_stream_s_per_epoch": {"K": k, **contact_s},
                     "scale_contact_stream_s_per_epoch": {"K": k2, "mean": t2},
                     "eager_p1": eager, "flops_per_vehicle_round": stats["flops"]}
    return fit


def drive_scale_pair(device: str, rehearsal: bool):
    """The reference's scale workload (``bench_scale_config``) at K=1024, once
    per contact format, through ``run_with_context`` after a 1-epoch warm-up:
    its sparse and dense epochs per second beside the H100 profile's
    prediction. The road net ``scale_grid`` is registered as
    ``benchmarks/engine_scale.py`` registers it (grid side round(sqrt(K)))."""
    k = 16 if rehearsal else SCALE_K
    side = max(3, int(round(k ** 0.5)))

    @topology.register_road_network("scale_grid")
    def scale_grid(seed: int = 0) -> topology.RoadNetwork:
        """Paper-density grid scaled with the fleet (side = sqrt(K))."""
        return topology.grid_net(side=side)

    ds = synthetic_mnist(n_train=512 if rehearsal else SCALE_N_TRAIN, n_test=256)
    base = replace(scenario_cost.bench_scale_config(k, "sparse", SCALE_EPOCHS), device=device)
    net = topology.make_road_network("scale_grid", seed=base.seed)
    d_max = engine.probe_d_max(base, net)
    runs, predicted, report = {}, {}, {"num_vehicles": k, "d_max": d_max, "grid_side": side}
    for fmt in ("sparse", "dense"):
        cfg = replace(scenario_cost.bench_scale_config(k, fmt, SCALE_EPOCHS, d_max=d_max),
                      device=device)
        run_simulation(replace(cfg, epochs=1), dataset=ds)            # warm-up
        timer = PhaseTimer(device)
        ctx = engine.build_context(cfg, dataset=ds, timer=timer)
        kernels_lib.reset_launch_counts()
        res, seconds = _seconds(lambda: engine.run_with_context(ctx))
        launches = dict(kernel.launch_counts)
        runs[fmt] = res
        predicted[fmt] = scenario_cost.predict_scenario(cfg, d_max=d_max,
                                                        host=scenario_cost.H100)
        report[fmt] = {"seconds_per_epoch": seconds / cfg.epochs, "launches": launches,
                       "device_ms_per_epoch": {n: v / cfg.epochs for n, v
                                               in sorted(timer.totals_ms().items())},
                       "contact_stream_s_per_epoch": _contact_stream_s(cfg, net),
                       "predicted": predicted[fmt].jsonable()}
        check(all(np.isfinite(np.asarray(t)).all()
                  for t in (res.kl_trace, res.comm_mb, res.avg_accuracy)),
              f"K={k} {fmt}: finite traces")
        if device != "cpu":
            used = "gossip_mix_gather" if fmt == "sparse" else "gossip_mix_matmul"
            check(launches[used] == cfg.epochs,
                  f"K={k} {fmt}: {used} launched {launches[used]} times = {cfg.epochs} rounds")
    err = max(np.abs(np.asarray(runs["sparse"].kl_trace) - np.asarray(runs["dense"].kl_trace)).max(),
              np.abs(np.asarray(runs["sparse"].comm_mb) - np.asarray(runs["dense"].comm_mb)).max())
    check(err <= 1e-5, f"K={k}: dense and sparse give the same kl_trace / comm_mb "
          f"(max diff {err:.2e})")
    row = scenario_cost.pair_row(
        f"sparse-vs-dense K={k}", 1 / report["sparse"]["seconds_per_epoch"],
        1 / report["dense"]["seconds_per_epoch"], predicted["sparse"], predicted["dense"],
        num_vehicles=k, d_max=d_max)
    return row, report


def drive_train_cli(device: str, rehearsal: bool) -> dict:
    """``python -m repro_torch.launch.train --arch mnist-cnn`` at K=100, 2
    epochs evaluated every epoch, into a temporary checkpoint directory; the
    checkpoint restored (``repro_torch.checkpoint``) must hold the history the
    run printed."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mnist-cnn",
            "--vehicles", "100", "--epochs", "2", "--eval-every", "1", "--device", device]
    if rehearsal:
        argv[argv.index("100")] = "8"
        argv += ["--local-steps", "1", "--batch-size", "8"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        out = subprocess.run(argv + ["--checkpoint-dir", tmp], capture_output=True, text=True,
                             timeout=600, cwd=str(SRC.parent), env=env)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            log(out.stdout[-4000:])
            log(out.stderr[-4000:])
        check(out.returncode == 0, f"the train CLI exits 0 ({wall:.1f} s, process start included)")
        printed = [float(line.split("avg_acc=")[1].split()[0])
                   for line in out.stdout.splitlines() if "avg_acc=" in line]
        from repro_torch import checkpoint as ckpt_lib
        mgr = ckpt_lib.CheckpointManager(tmp)
        history, step = mgr.restore_latest(
            {"avg_accuracy": torch.zeros(2, dtype=torch.float64)})
        restored = history["avg_accuracy"].tolist()
        check(step == 2 and len(printed) == 2
              and np.allclose(restored, printed, atol=5e-5, rtol=0),
              f"checkpoint ckpt_{step}.npz restores the printed history: {restored} vs {printed}")
        meta = ckpt_lib.metadata(os.path.join(tmp, f"ckpt_{step}.npz"))
    return {"argv": argv[1:], "wall_s": wall, "printed": printed, "restored": restored,
            "metadata": meta}


def drive_cost_model(full: SimulationConfig, d_max: int, dataset, reports: list,
                     timings: dict, p1_facts, sharded: dict, rehearsal: bool) -> dict:
    """The cost model and ``execution="auto"`` on this card: the H100 profile's
    constants measured in this run beside the committed ones, the plan
    ``resolve_auto`` makes at the paper's configuration, an auto run against
    the manual run of the configuration it resolved to, the sparse-vs-dense
    pairs at K=100 (the main path's two runs) and K=1024 (the reference's
    scale workload) predicted against measured, and the train CLI with its
    checkpoint. A ranking MISMATCH fails the phase, as the reference's
    cost-model CLI exits 1 on one."""
    device = full.device
    h100 = scenario_cost.H100
    report = {}
    log(f"[cost model] the reference's scale workload, K={16 if rehearsal else SCALE_K}")
    scale_row, report["scale"] = drive_scale_pair(device, rehearsal)
    log(f"  {json.dumps(report['scale'])}")
    if not rehearsal:
        fit = fit_h100_profile(full, d_max, reports, timings, p1_facts, sharded,
                               report["scale"])
        log("[cost model] H100 profile: measured in this run | committed")
        for name, value in fit.items():
            if name != "inputs":
                log(f"  {name}: {value:.6g} | {getattr(h100, name):.6g}")
        log(f"  fit inputs: {json.dumps(fit['inputs'])}")
        report["fit"] = fit

    # the plan at the paper's K=100 configuration
    by_format = {r["contact_format"]: r for r in reports}
    resolved, plan = engine.resolve_execution(replace(full, execution="auto"))
    chosen = by_format[resolved.contact_format]
    log(f"[cost model] plan at K={full.num_vehicles}: {json.dumps(plan)}")
    log(f"  chose {resolved.backend}/{resolved.contact_format}/{resolved.mixing_backend}: "
        f"predicted {plan['predicted_epochs_per_s']:.4f} epochs/s "
        f"({1 / plan['predicted_epochs_per_s']:.5f} s/epoch); measured "
        f"{chosen['seconds_per_epoch']:.5f} s/epoch ({1 / chosen['seconds_per_epoch']:.4f} epochs/s)")
    check(plan["host_profile"] == ("ci_host" if rehearsal else "h100")
          and resolved.execution == "manual" and plan["device_count"] == 1,
          f"resolve_auto on {device} uses the {plan['host_profile']} profile, one rank")
    report["plan"] = plan

    # execution="auto" through run_simulation against the manual run it resolved to
    auto = run_simulation(replace(full, execution="auto", epochs=2), dataset=dataset)
    manual = run_simulation(auto.config, dataset=dataset)
    diff = max(float(np.abs(np.asarray(getattr(auto, f)) - np.asarray(getattr(manual, f))).max())
               for f in ("avg_accuracy", "kl_trace", "comm_mb"))
    check(auto.execution_plan is not None and auto.execution_plan["requested"] == "auto"
          and manual.execution_plan is None and diff <= 1e-5,
          f"execution='auto' run_simulation stamps its plan and follows the manual run of "
          f"{auto.config.contact_format}/{auto.config.mixing_backend} (max diff {diff:.2e})")

    # sparse against dense: K=100 from the main path's runs; K=1024 the scale workload
    predicted = {fmt: scenario_cost.predict_scenario(replace(full, contact_format=fmt),
                                                      d_max=d_max, host=h100)
                 for fmt in ("sparse", "dense")}
    rows = [scenario_cost.pair_row(
        f"sparse-vs-dense K={full.num_vehicles}", 1 / by_format["sparse"]["seconds_per_epoch"],
        1 / by_format["dense"]["seconds_per_epoch"], predicted["sparse"], predicted["dense"],
        num_vehicles=full.num_vehicles, d_max=d_max)]
    log(f"  K={full.num_vehicles} predicted: "
        + json.dumps({f: b.jsonable() for f, b in predicted.items()}))
    rows.append(scale_row)
    table = scenario_cost.predicted_vs_measured_table([], rows, profile=h100.name)
    for line in table.splitlines():
        log(f"  {line}")
    report["pairs"] = rows
    bad = [r["pair"] for r in rows if r["verdict"] == "MISMATCH"]
    if rehearsal:
        log(f"  rehearsal: CPU times against the H100 profile, not gated ({bad or 'no MISMATCH'})")
    else:
        check(not bad, f"no ranking MISMATCH on {[r['pair'] for r in rows]}")

    log("[cost model] the train CLI at K=100, its checkpoint restored")
    report["train_cli"] = drive_train_cli(device, rehearsal)
    log(f"  {json.dumps(report['train_cli'])}")
    return report


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise SystemExit(f"FAILED: nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu-rehearsal", action="store_true",
                        help="tiny sizes on the CPU, no kernels; exits 3")
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after the kernels phase (a first look at a new "
                             "kernel); exits 3")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("FAILED: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = "cpu" if rehearsal else "cuda"
    card = "cpu rehearsal" if rehearsal else nvidia_smi_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # -- 2. build -----------------------------------------------------------
    sources = [src for module in kernels_lib.KERNEL_MODULES for src in module.SOURCES.values()]
    if not rehearsal:
        t0 = time.perf_counter()
        kernels_lib.build_all()
        log(f"[build] {len(sources)} kernels built into {build_lib.build_dir()} "
            f"in {time.perf_counter() - t0:.1f} s")
        for source in sources:
            for line in build_lib.build_log(source).splitlines():
                if "registers" in line or "spill" in line or "entry function" in line:
                    log(f"  {source.name}: {line.strip()}")
        # dynamic shared memory per block of the kernels redesigned for Hopper
        log(f"  eg_solve.cu: V=K=100: shared memory {kl_simplex.kernel.eg_solve_smem_bytes(100, 100)}"
            f" B per block of 256 threads; limit V=K={kl_simplex.kernel.eg_solve_max_k()}")
        for dtype in (torch.float32, torch.bfloat16):
            log(f"  gossip_mix_matmul.cu: {dtype} K=100: shared memory "
                f"{kernel.matmul_smem_bytes(100, 100, dtype)} B per block of 256 threads")
            for hd in fa.kernel.HEAD_DIMS:
                for group in (1, 2):
                    log(f"  flash_attention.cu: {dtype} hd={hd} G={group}: "
                        f"{json.dumps(fa.kernel.block_resources(hd, dtype, group))}")

    # the configuration of the main path
    full = SimulationConfig(
        algorithm="dds", dataset="mnist", epochs=EPOCHS, eval_every=2,
        seed=args.seed, mixing_backend="cuda", device=device)
    if rehearsal:
        full = replace(full, num_vehicles=8, local_steps=2, batch_size=8, p1_steps=10,
                       eval_samples=64, comm_range=250.0)
    net = topology.make_road_network(full.road_net, seed=full.seed)
    d_max = engine.probe_d_max(full, net)
    log(f"[config] K={full.num_vehicles} E={full.local_steps} B={full.batch_size} "
        f"p1_steps={full.p1_steps} epochs={full.epochs} d_max={d_max}")

    # -- 3. kernels ---------------------------------------------------------
    timings, worst = {}, {name: None for name in KERNELS}
    shard_timings, shard_worst = {}, {}
    if not rehearsal:
        log("[kernels] against the plain versions on the card")
        with engine.full_f32_matmul():
            worst = check_kernels(device, full.num_vehicles, d_max)
            worst.update(check_kl_kernels(device, full.num_vehicles, full.p1_steps))
            first = contacts_lib.to_device(engine.ContactStream(full, net).window(1), device)
            first = contacts_lib.epoch_of(first, 0)
            mixing_sparse = aggregation.uniform_mixing(first)
            mixing_dense = torch.as_tensor(
                contacts_lib.mixing_to_dense(mixing_sparse)).to(device)
            seeds_sparse, seeds_dense = seed_mixings(full, device)
            log(f"[kernels] the mixes with the seed axis (S={len(SEEDS)}) on the card")
            for name, err in check_seed_kernels(device, seeds_sparse, seeds_dense).items():
                worst[name] = max(worst[name], err)
            log(f"[kernels] the mixes on per-shard blocks (N={SHARD_COUNTS}) on the card")
            shard_worst = check_shard_kernels(device, mixing_sparse, mixing_dense)
            log("[kernels] times at the main path's shapes (ms, CUDA events, median)")
            timings = time_kernels(device, mixing_sparse, mixing_dense)
            log("[kernels] gossip_mix_matmul's mappings per K: the crossover")
            time_matmul_crossover(device)
            for name, row in time_seed_kernels(device, seeds_sparse, seeds_dense).items():
                timings[name]["seed_axis"] = row
            shard_timings = time_shard_kernels(device, mixing_sparse, mixing_dense)
            timings.update(time_kl_kernels(device, full.num_vehicles, full.p1_steps))
        fa_errors = check_flash_attention(device)
        worst["flash_attention"] = fa_errors.pop("max_abs_err")
        log("[kernels] flash_attention at the serving shape (ms, CUDA events, median)")
        with full_f32_matmul():
            timings.update(time_flash_attention(device))
        timings["flash_attention"].update(fa_errors)
        log("[kernels] flash_train (the train step's attention) at cells 6's and 2's "
            "per-layer shapes (ms, CUDA events, median)")
        train_worst, train_rows = check_and_time_train_attention(device)
        worst.update(train_worst)
        timings.update(train_rows)
        log("[kernels] grouped_mm / grouped_mm_wgrad at the MoE prefill shapes (ms, CUDA "
            "events, median)")
        grouped_worst, grouped_timings = check_grouped_kernels(device)
        worst.update(grouped_worst)
        timings.update(grouped_timings)
        log("[kernels] adamw at one vehicle step of cells 6 and 2 (ms, CUDA events, median)")
        adamw_worst, adamw_timings = check_and_time_adamw(device)
        worst.update(adamw_worst)
        timings.update(adamw_timings)

    if args.kernels_only:
        log("[kernels-only] stopping before the main path")
        return 3

    # -- 8e. dryrun: started now, on the host; collected after the card's phases
    dryrun = start_dryrun(rehearsal)

    # -- 4. main path -------------------------------------------------------
    if rehearsal:
        dataset = synthetic_mnist(seed=args.seed, n_train=800, n_test=64)
    else:
        t0 = time.perf_counter()
        dataset = data_lib.load_dataset(full.dataset, seed=full.seed)
        log(f"[data] {dataset.name}: {dataset.train_x.shape} train, "
            f"{dataset.test_x.shape} test in {time.perf_counter() - t0:.1f} s")
    log("[main path] warm-up (one epoch, not counted)")
    run_simulation(replace(full, epochs=1), dataset=dataset)
    results, launches, reports, finals = {}, {}, [], []
    for fmt in ("sparse", "dense"):
        log(f"[main path] run_simulation, contact_format={fmt}")
        res, ctx, counts, report = drive_main_path(replace(full, contact_format=fmt), dataset)
        results[fmt] = res
        launches.update({n: c for n, c in counts.items() if c})
        reports.append(report)
        finals.append(_final_diagnostics(ctx, res))
        # the next epoch's contacts: one more round here, and the P1 inputs
        next_contacts = contacts_lib.epoch_of(
            contacts_lib.to_device(ctx.contacts.window(1), ctx.device), 0)
        with engine.full_f32_matmul():
            check_kernel_path_against_torch_mix(ctx, next_contacts)
    sparse, dense = results["sparse"], results["dense"]
    err = max(np.abs(np.asarray(sparse.kl_trace) - np.asarray(dense.kl_trace)).max(),
              np.abs(np.asarray(sparse.comm_mb) - np.asarray(dense.comm_mb)).max())
    check(err <= 1e-5, f"dense and sparse give the same kl_trace / comm_mb (max diff {err:.2e})")
    log(f"[main path] {json.dumps({'per_epoch': reports})}")

    # -- 5. the P1 entry point at full width (the dense run's last state) ---
    log("[P1] core.kl_solver.solve_p1_all vs the plain loop of kernels.kl_simplex.ref")
    with engine.full_f32_matmul():
        p1_launches, p1_facts = check_fused_p1(full, ctx.final_state.state_matrix, ctx.target,
                                               next_contacts, P1_K_PAST_LIMIT, args.seed)
    launches.update(p1_launches)
    if timings:
        timings["eg_step"]["solve_launches"] = launches["eg_solve"]
    del ctx

    # -- 6. the baselines at full width --------------------------------------
    seconds, baseline_finals = drive_baselines(full, dataset)
    finals += baseline_finals
    log(f"[baselines] {json.dumps({'seconds_per_epoch': seconds})}")

    # -- 6b. seeds: run_seeds at full width, delayed gossip, the campaign ---
    seeds_report, seed_launches = drive_seeds(full, dataset)
    log(f"[seeds] {json.dumps(seeds_report)}")
    log("[seeds] the delayed-gossip anchor (W = I) bit for bit")
    check_delayed_anchor(full)
    campaign = drive_campaign(device, rehearsal)

    # -- 6c. sharded: the shard_map backend on N = 2 and 4 ranks ------------
    vmap_runs = {"sparse/sync": results["sparse"], "dense/sync": results["dense"],
                 "sparse/delayed": run_simulation(replace(full, overlap="delayed"),
                                                  dataset=dataset)}
    sharded_report, shard_launches = drive_sharded(full, dataset, vmap_runs)

    # -- 6d. the cost model, execution="auto" and the train CLI -------------
    t0 = time.perf_counter()
    drive_cost_model(full, d_max, dataset, reports, timings, p1_facts, sharded_report,
                     rehearsal)
    log(f"[cost model] phase took {time.perf_counter() - t0:.1f} s")

    # -- 7. diagnostics kernels on every final state; card against the CPU --
    log("[diagnostics] kl_rows / entropy_rows on each run's final state matrix")
    launches.update(check_diagnostics(finals, device))
    if not rehearsal:
        log("[diagnostics] small federations on the card against the CPU")
        check_card_against_cpu(device)

    # -- 8. the serving path: qwen3-1.7b prefill + greedy decode ------------
    launches["flash_attention"], _ = drive_serve(device, args.seed, rehearsal)

    # -- 8b. the zoo: every other family's serving path at full width -------
    zoo_launches, _ = drive_zoo(device, args.seed, rehearsal)
    launches["flash_attention"] += zoo_launches

    # -- 8c. train: DFL-DDS rounds of vehicle transformers at full width -----
    train_launches, train_err, train_timing, train_report, round1 = drive_train(
        device, args.seed, rehearsal)

    # -- 8d. mesh-train: the same round on a federation mesh of one rank -----
    mesh_launches, mesh_err, mesh_timing, mesh_report = drive_mesh_train(
        device, args.seed, rehearsal, round1)
    del round1

    # -- 8f. ragged: granite-moe through the grouped products, served and trained
    ragged_launches, _ = drive_ragged(device, args.seed, rehearsal)
    launches.update(ragged_launches)
    launches["adamw"] += (sum(train_report[run]["adamw_launches"] for run in ("model", "cli"))
                          + mesh_report["adamw_launches"])

    # -- 8g. examples: every torch example with --smoke, as a user starts it --
    log(f"[examples] {json.dumps(drive_examples(device))}")

    # -- 8e. dryrun: the records of the processes started after the build ----
    finish_dryrun(dryrun)

    # -- 9. the record ------------------------------------------------------
    if rehearsal:
        log(f"[rehearsal] control flow ok in {time.perf_counter() - t_start:.1f} s; "
            "no kernel ran, nothing was measured")
        return 3
    rows = []
    for name, meta in KERNELS.items():
        check(launches.get(name, 0) > 0, f"its path launched {name}")
        rows.append({"name": name, **meta, "launches": launches[name],
                     "max_abs_err": worst[name], **timings[name]})
        if name in seed_launches:
            check(seed_launches[name] > 0, f"the seeds path launched {name}")
            rows[-1]["seed_axis"]["launches"] = seed_launches[name]
    check(train_launches > 0, "the train path launched gossip_mix_matmul")
    rows.append({"name": "gossip_mix_matmul/train", **KERNELS["gossip_mix_matmul"],
                 "launches": train_launches, "max_abs_err": train_err, **train_timing})
    check(mesh_launches > 0, "the mesh-train path launched gossip_mix_matmul")
    rows.append({"name": "gossip_mix_matmul/mesh", **KERNELS["gossip_mix_matmul"],
                 "launches": mesh_launches, "max_abs_err": mesh_err, **mesh_timing})
    for name, count in shard_launches.items():
        check(count > 0, f"the sharded path launched {name}")
        rows.append({"name": f"{name}/shard", **KERNELS[name], "launches": count,
                     "max_abs_err": shard_worst[name], **shard_timings[name]})
    log(f"[seeds] campaign {campaign['n_passed']}/{campaign['n_checks']} ordering checks "
        f"passed in {campaign['wall_s']:.1f} s")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
