"""The analytic counts behind every ``mfu`` and roofline share, pinned."""
import json
from pathlib import Path

import pytest

from bench.costs import cnn, granite, grouped_mm, peaks

ROOT = Path(__file__).resolve().parents[1]
MNIST = json.loads((ROOT / "bench/configs/mnist-cnn.json").read_text())
GRANITE = json.loads((ROOT / "bench/configs/granite-moe-1b-a400m.json").read_text())


def test_cnn_forward_is_0_961_mflop():
    assert cnn.FORWARD == 961_000
    assert cnn.train_sample_flops() == 2_883_000


def test_cnn_epoch_and_federation():
    train = 100 * 8 * 80 * 2_883_000
    evaluated = 100 * 2000 * 961_000
    assert cnn.epoch_flops(MNIST, False) == train
    assert cnn.epoch_flops(MNIST, True) == train + evaluated
    # 50 epochs evaluated 5 times: about 203 GFLOP an epoch
    total = cnn.federation_flops(MNIST, 50)
    assert total == 50 * train + 5 * evaluated
    assert total / 50 == pytest.approx(2.03732e11, rel=1e-6)


def test_granite_active_params_and_round():
    attn = 1024 * 1024 + 2 * 1024 * 512 + 1024 * 1024
    per_layer = attn + 1024 * 32 + 8 * 3 * 1024 * 512
    assert granite.active_matmul_params(GRANITE) == 24 * per_layer + 49155 * 1024
    assert granite.active_matmul_params(GRANITE) == 428_608_512
    r4096 = granite.round_flops(GRANITE, 2, 1, 4096)
    r1024 = granite.round_flops(GRANITE, 2, 4, 1024)
    assert r4096 == pytest.approx(8192 * (6 * 428_608_512 + 6 * 24 * 1024 * 4096))
    assert r4096 == pytest.approx(2.6015e13, rel=1e-4)
    assert r1024 == pytest.approx(2.2304e13, rel=1e-4)


def test_grouped_mm_counts():
    m = 4096 * 8
    flops, nbytes = grouped_mm.product(m, 1024, 512, 32, 2)
    assert flops == 2 * m * 1024 * 512
    assert nbytes == 2 * (m * 1024 + m * 512 + 32 * 1024 * 512) + 4 * 33
    assert grouped_mm.launches_per_vehicle_step(GRANITE) == (216, 72)
    least = grouped_mm.least_seconds_per_launch(GRANITE, 4096, 2, "bf16")
    assert least == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)     # byte-bound
    assert least == pytest.approx(40.06e-6, rel=1e-3)


def test_peaks():
    assert peaks.FLOPS == {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12}
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.least_seconds(1e12, 1.0, "bf16") == pytest.approx(1 / 989)
