"""Flash attention: the hand-written Hopper kernel, its plain version and the
model adapter (``make_attn_impl``)."""
from .kernel import flash_attention  # noqa: F401
from .ops import attend, make_attn_impl  # noqa: F401
from .ref import flash_attention_ref  # noqa: F401
