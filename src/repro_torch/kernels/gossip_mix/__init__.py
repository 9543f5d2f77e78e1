from .kernel import (gossip_mix_gather, gossip_mix_gather_grouped,  # noqa: F401
                     gossip_mix_matmul, gossip_mix_matmul_grouped, leaf_groups)
from .ops import mix_params_cuda, mix_params_cuda_  # noqa: F401
from .ref import gossip_mix_gather_ref, gossip_mix_matmul_ref  # noqa: F401
