"""NVIDIA H100 SXM hardware constants (the port's target card).

Counterpart of ``repro.roofline.hw``: NVIDIA's published figures for one
H100 SXM at its full 700 W power limit, dense rates without sparsity. A card
set below 700 W runs slower under load (``nvidia-smi --query-gpu=power.limit``
says where a card is set).
"""

F32_FLOP_PER_S = 67e12         # f32 on the CUDA cores, outside the tensor cores
TF32_FLOP_PER_S = 495e12       # TF32 on the tensor cores, dense
BF16_FLOP_PER_S = 989e12       # bf16 on the tensor cores, dense

HBM_BYTES_PER_S = 3.35e12      # HBM3 bandwidth
HBM_BYTES = 80 * 1024**3       # device memory

SMS = 132                      # streaming multiprocessors
SMEM_BYTES_PER_SM = 228 * 1024 # shared memory per SM
SMEM_BYTES_PER_BLOCK = 227 * 1024  # the most one block may opt in to
THREADS_PER_SM = 2048          # resident threads per SM

NVLINK_BYTES_PER_S = 900e9     # NVLink 4, per card, all links
