"""Architecture config schema + divisibility padding for the model mesh axis.

A copy of ``repro.configs.base`` (pure data, no JAX): the port keeps its own
so that it never imports the JAX package."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int               # 0 for attention-free archs
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None   # native SWA (mixtral: 4096)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_impl: str = "dense"      # dense (compute-all) | ragged (sorted grouped matmul)

    # SSM / hybrid
    ssm_state: int = 0           # mamba state size (hymba) / rwkv head state
    attn_free: bool = False      # rwkv6
    hybrid: bool = False         # hymba: parallel attn + ssm heads

    # multimodal frontends (vlm/audio): model consumes embeddings for a prefix
    embed_input: bool = False
    frontend_tokens: int = 0     # patches/frames provided by the stub frontend

    tie_embeddings: bool = False

    # true (unpadded) sizes — set by pad_for_mesh, equal to the nominal sizes otherwise
    true_vocab_size: int = 0
    true_num_heads: int = 0
    true_num_kv_heads: int = 0

    # port-only options, fields of ``DeepseekV3Config``: neutral here, so the
    # reference's architectures keep the reference's fields exactly
    kv_lora_rank: ClassVar[int] = 0
    qk_rope_dim: ClassVar[int] = 0
    v_head_dim: ClassVar[int] = 0
    first_dense_layers: ClassVar[int] = 0
    dense_d_ff: ClassVar[int] = 0
    shared_experts: ClassVar[int] = 0
    router: ClassVar[str] = "softmax"
    routed_scale: ClassVar[float] = 1.0
    expert_range: ClassVar[tuple[int, int] | None] = None
    aux_weight: ClassVar[float] = 0.01

    def __post_init__(self):
        if self.true_vocab_size == 0:
            object.__setattr__(self, "true_vocab_size", self.vocab_size)
        if self.true_num_heads == 0:
            object.__setattr__(self, "true_num_heads", self.num_heads)
        if self.true_num_kv_heads == 0:
            object.__setattr__(self, "true_num_kv_heads", self.num_kv_heads)

    # ------------------------------------------------------------------ sizes

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def value_dim(self) -> int:
        """The value head width (head_dim unless MLA gives its own)."""
        return self.v_head_dim or self.head_dim

    @property
    def held_experts(self) -> tuple[int, int]:
        """The experts this device holds, ``[lo, hi)`` of the router's."""
        return self.expert_range or (0, self.num_experts)

    def param_count(self) -> int:
        """Total parameter count N (with current padding; of an expert share,
        the experts held)."""
        d, L, L0 = self.d_model, self.num_layers, self.first_dense_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.is_mla:
            h, r, rope = self.num_heads, self.kv_lora_rank, self.qk_rope_dim
            per_layer += (d * h * self.head_dim + d * (r + rope) + r
                          + r * h * (self.head_dim - rope + self.value_dim)
                          + h * self.value_dim * d)
        elif not self.attn_free:
            q = d * self.num_heads * self.head_dim
            kv = 2 * d * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * d
            per_layer += q + kv + o
            if self.qkv_bias:
                per_layer += (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        if self.attn_free:  # rwkv6 time-mix
            per_layer += 4 * d * d + d * d  # r,k,v,g,o projections
            per_layer += 2 * d * 32 * 6     # ddlerp / decay loras (approx)
        if self.hybrid:     # mamba branch alongside attention
            per_layer += 2 * d * d + 2 * d * self.ssm_state * 2
        per_layer += 2 * d  # norms
        if self.is_moe:
            lo, hi = self.held_experts
            ffn = (hi - lo) * 3 * d * self.d_ff + d * self.num_experts
            ffn += self.shared_experts * 3 * d * self.d_ff
            if self.router == "sigmoid":
                ffn += self.num_experts
        else:
            ffn = 3 * d * self.d_ff
        return emb + L * per_layer + (L - L0) * ffn + L0 * 3 * d * self.dense_d_ff + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts; of an expert
        share, its expected part of them, rounded down)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers - self.first_dense_layers
        lo, hi = self.held_experts
        held, e = hi - lo, self.num_experts
        inactive = L * 3 * d * self.d_ff * (held * e - self.top_k * held) // e
        return self.param_count() - inactive

    # --------------------------------------------------------------- padding

    def pad_for_mesh(self, model_shards: int) -> "ArchConfig":
        """Pad head counts / vocab to multiples of the model-parallel degree.

        Padded q-heads are mathematically inert (their W_o rows are zero);
        padded kv-heads serve only padded q-heads; padded vocab logits are
        masked to -inf. See DESIGN.md §4.
        """
        changes: dict = {}
        if self.num_heads and self.num_heads % model_shards:
            changes["num_heads"] = _ceil_to(self.num_heads, model_shards)
        if self.num_kv_heads and self.num_kv_heads % model_shards:
            if self.num_kv_heads < model_shards:
                # replicate-kv regime (kv < shards) is allowed; just keep the
                # GQA grouping aligned with the (possibly padded) q-heads.
                nh = changes.get("num_heads", self.num_heads)
                if nh % self.num_kv_heads:
                    changes["num_kv_heads"] = _gcd_pad(nh, self.num_kv_heads)
            else:
                changes["num_kv_heads"] = _ceil_to(self.num_kv_heads, model_shards)
        nh = changes.get("num_heads", self.num_heads)
        nkv = changes.get("num_kv_heads", self.num_kv_heads)
        if nkv and nh % nkv:
            changes["num_kv_heads"] = _gcd_pad(nh, nkv)
        if self.vocab_size % model_shards:
            changes["vocab_size"] = _ceil_to(self.vocab_size, model_shards)
        if not changes:
            return self
        return dataclasses.replace(
            self,
            true_vocab_size=self.true_vocab_size,
            true_num_heads=self.true_num_heads,
            true_num_kv_heads=self.true_num_kv_heads,
            **changes,
        )

    # ----------------------------------------------------------------- smoke

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model<=512 variant of the same family for CPU smoke tests."""
        d = min(self.d_model, 256)
        hd = min(self.head_dim, 64)
        nh = max(1, min(self.num_heads, d // hd)) if self.num_heads else 0
        nkv = max(1, min(self.num_kv_heads, nh)) if self.num_kv_heads else 0
        if nkv and nh % nkv:
            nkv = 1
        extra: dict = {}
        if self.is_mla:
            extra.update(kv_lora_rank=min(self.kv_lora_rank, 32),
                         qk_rope_dim=min(self.qk_rope_dim, hd // 4),
                         v_head_dim=min(self.value_dim, hd // 2))
        if self.first_dense_layers:
            extra.update(first_dense_layers=1, dense_d_ff=min(self.dense_d_ff, 512))
        if self.expert_range is not None:
            extra["expert_range"] = None
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            frontend_tokens=min(self.frontend_tokens, 16) if self.frontend_tokens else 0,
            true_vocab_size=0, true_num_heads=0, true_num_kv_heads=0,
            **extra,
        )


@dataclass(frozen=True)
class DeepseekV3Config(ArchConfig):
    """A deepseek_v3 architecture (a port-only family: the JAX package has
    none)."""

    # latent attention (MLA, deepseek_v3), on where kv_lora_rank > 0: head_dim
    # is the query / key width, qk_nope + qk_rope_dim; v_head_dim the value's
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # deepseek_v3 MoE: leading dense layers of SwiGLU width dense_d_ff before
    # the MoE layers; shared experts (one SwiGLU of width shared_experts x
    # d_ff); the router ("softmax" with the Switch aux loss, or "sigmoid": a
    # selection-only bias, routed_scale on the renormalised weights and
    # DeepSeek-V3's sequence-wise aux loss); the held share of the router's
    # num_experts, [lo, hi) (None: all); the aux loss's weight
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    shared_experts: int = 0
    router: str = "softmax"
    routed_scale: float = 1.0
    expert_range: tuple[int, int] | None = None
    aux_weight: float = 0.01


def _gcd_pad(num_heads: int, num_kv: int) -> int:
    """Smallest kv count >= num_kv that divides num_heads."""
    k = num_kv
    while num_heads % k:
        k += 1
    return k
