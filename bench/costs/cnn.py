"""Operations of the paper's MNIST CNN (Sec. VI-A.2), counted from its
shapes: multiply-adds of the two 5 x 5 convolutions and the two dense layers,
two operations each. Biases, ReLU, pooling and dropout are not counted."""

CONV1 = 2 * 24 * 24 * 10 * (5 * 5 * 1)      # 28x28x1 -> 24x24x10
CONV2 = 2 * 8 * 8 * 20 * (5 * 5 * 10)       # 12x12x10 -> 8x8x20
FC1 = 2 * 320 * 50
FC2 = 2 * 50 * 10
FORWARD = CONV1 + CONV2 + FC1 + FC2         # 961,000 per sample


def train_sample_flops() -> int:
    """A training sample: the forward pass and a backward pass of twice its
    operations."""
    return 3 * FORWARD


def epoch_flops(cfg: dict, evaluated: bool) -> int:
    """One federation epoch: K vehicles x E steps x B samples trained, plus
    ``eval_samples`` forward passes per vehicle on an evaluated epoch."""
    k = cfg["num_vehicles"]
    train = k * cfg["local_steps"] * cfg["batch_size"] * train_sample_flops()
    return train + (k * cfg["eval_samples"] * FORWARD if evaluated else 0)


def federation_flops(cfg: dict, epochs: int) -> int:
    """A federation of ``epochs`` epochs, evaluated every ``eval_every``-th
    epoch and on its last."""
    evals = sum(1 for t in range(epochs)
                if (t + 1) % cfg["eval_every"] == 0 or t == epochs - 1)
    return (epochs - evals) * epoch_flops(cfg, False) + evals * epoch_flops(cfg, True)
