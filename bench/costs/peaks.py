"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak of ``precision`` and bytes over the memory bandwidth."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
