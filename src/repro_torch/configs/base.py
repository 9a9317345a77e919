"""Architecture + runtime configuration dataclasses (a copy of
`repro.configs.base`, with its own `pad_vocab` so the port imports
nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | vlm | audio_encdec | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0          # total shared-expert ff width (0 = none)
    moe_layer_period: int = 1         # MoE MLP every `period` layers
    moe_layer_offset: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (Jamba): attention layer every `attn_layer_period`, rest SSM
    attn_layer_period: int = 0
    attn_layer_offset: int = 0

    # VLM: cross-attention to image embeddings every `cross_attn_period`
    cross_attn_period: int = 0
    cross_attn_offset: int = 0
    num_image_tokens: int = 0

    # encoder-decoder (audio): encoder depth; frontend supplies embeddings
    encoder_layers: int = 0

    # sub-quadratic context support (long_500k eligibility)
    sub_quadratic: bool = False

    # per-arch sharding rule overrides, merged over the active profile
    sharding_overrides: Tuple[Tuple[str, object], ...] = ()
    # per-arch RunConfig overrides (e.g. bf16 optimizer state for >=90B)
    run_overrides: Tuple[Tuple[str, object], ...] = ()

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:        # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_layer_period:
            return i % self.attn_layer_period == self.attn_layer_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe_num_experts:
            return False
        return i % self.moe_layer_period == self.moe_layer_offset

    def is_cross_attn_layer(self, i: int) -> bool:
        if not self.cross_attn_period:
            return False
        return i % self.cross_attn_period == self.cross_attn_offset

    @property
    def layer_period(self) -> int:
        """Smallest repeating block period (for roofline extrapolation)."""
        p = 1
        if self.attn_layer_period:
            p = max(p, self.attn_layer_period)
        if self.moe_num_experts and self.moe_layer_period > 1:
            p = max(p, self.moe_layer_period)
        if self.cross_attn_period:
            p = max(p, self.cross_attn_period)
        return p

    def with_layers(self, n: int) -> "ModelConfig":
        kw = {"num_layers": n}
        if self.encoder_layers:
            kw["encoder_layers"] = n
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        P = self.layer_period
        kw = dict(
            num_layers=P, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128 if self.d_ff else 0, vocab_size=256,
        )
        if self.moe_num_experts:
            kw.update(moe_num_experts=8, moe_top_k=min(self.moe_top_k, 2),
                      moe_d_ff=32,
                      moe_shared_d_ff=64 if self.moe_shared_d_ff else 0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.cross_attn_period:
            kw.update(num_image_tokens=8)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime/distribution knobs — the hillclimbing levers."""
    sharding_profile: str = "train"     # train | train_sp | decode | long
    remat: bool = True
    remat_policy: str = "period"        # period | block
    scan_layers: bool = True            # False => unrolled (roofline path)
    unroll_attn: bool = False           # unroll chunked-attention loops
    num_microbatches: int = 1
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    attn_chunk_q: int = 2048
    attn_chunk_k: int = 2048
    attention_impl: str = "xla"         # xla (chunked jnp) | pallas
    attn_acc_dtype: str = "float32"     # bfloat16 halves score-intermediate
                                        # bytes (hillclimb lever)
    zero3_at_use: bool = False          # all-gather FSDP weights per layer
                                        # instead of activation all-reduce
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    donate_state: bool = True

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §4)"
    return True, ""
