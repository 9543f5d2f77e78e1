"""Flash attention: the hand-written Hopper kernels (serving forward; training
forward and backward), their plain versions and the model adapters
(``make_attn_impl``, ``make_train_attn_impl``)."""
from .kernel import flash_attention, flash_train_attention  # noqa: F401
from .ops import attend, make_attn_impl, make_train_attn_impl  # noqa: F401
from .ref import (flash_attention_ref, flash_train_backward_ref,  # noqa: F401
                  flash_train_forward_ref)
