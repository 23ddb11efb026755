"""Model configuration schema shared by all 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention
    qkv_bias: bool = False         # qwen2-style QKV bias
    rope_theta: float = 10_000.0
    use_rope: bool = True          # whisper uses absolute positions instead
    local_window: int = 0          # >0: sliding-window attention
    max_position: int = 1 << 20    # abs-pos table size when use_rope=False

    # MLP
    gated_mlp: bool = True         # SwiGLU/GeGLU vs plain 4x MLP
    act: str = "silu"              # silu | gelu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    first_dense_layers: int = 0    # deepseek: leading dense layer(s)
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (recurrentgemma): cycled per-layer kinds
    pattern: Tuple[str, ...] = ("attn",)   # attn | local_attn | rglru | ssm | moe
    rglru_width: int = 0           # 0 -> d_model
    rglru_c: float = 8.0

    # encoder-decoder
    encoder_layers: int = 0
    decoder_max_len: int = 448     # whisper decoder positions

    # modality frontend STUB (phi-3-vision patches, whisper frames)
    frontend: str = "none"         # none | patch | frames
    frontend_len: int = 0          # prefix embeddings per example (vlm)

    # assembly / numerics
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: str = "full"            # none | full | dots
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # performance variants (§Perf hillclimb; defaults = paper-faithful
    # baseline configuration)
    sp_decode_attn: bool = False   # shard_map LSE-combine decode attention
    moe_combine: str = "scatter"   # scatter | gather combine after experts
    moe_impl: str = "dense"        # dense (pjit) | ep (shard_map all_to_all)
    shard_strategy: str = "fsdp_tp"  # fsdp_tp | fsdp2d (activations never
                                     # model-sharded; weights 2D-sharded)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def rnn_width(self) -> int:
        return self.rglru_width or self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def num_periods(self) -> int:
        """How many full pattern periods fit in the (decoder) stack."""
        body = self.num_layers - self.first_dense_layers
        return body // len(self.pattern)

    def tail_kinds(self) -> Tuple[str, ...]:
        """Layer kinds after the last full period (unrolled)."""
        body = self.num_layers - self.first_dense_layers
        rem = body % len(self.pattern)
        return self.pattern[:rem]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline's
        MODEL_FLOPS = 6*N*D."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        if not self.use_rope:
            n += self.max_position_actual() * d
        for kind in self._all_kinds():
            n += self._block_params(kind)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE counts only routed-in experts)."""
        d, v = self.d_model, self.vocab_size
        n = v * d * (1 if self.tie_embeddings else 2)
        for kind in self._all_kinds():
            n += self._block_params(kind, active_only=True)
        n += d
        return n

    # -- helpers ---------------------------------------------------------
    def _all_kinds(self):
        kinds = ["dense_mlp"] * self.first_dense_layers
        body = self.num_layers - self.first_dense_layers
        for i in range(body):
            kinds.append(self.pattern[i % len(self.pattern)])
        if self.encoder_layers:
            kinds += ["enc_attn"] * self.encoder_layers
        return kinds

    def _block_params(self, kind: str, active_only: bool = False) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp_mult = 3 if self.gated_mlp else 2
        mlp = mlp_mult * d * self.d_ff
        if kind in ("attn", "local_attn"):
            if kind == "attn" and self.num_experts and not active_only:
                experts = self.num_experts + self.num_shared_experts
                moe = mlp_mult * d * self.moe_d_ff * experts + d * self.num_experts
                return attn + moe
            if kind == "attn" and self.num_experts and active_only:
                experts = self.experts_per_token + self.num_shared_experts
                moe = mlp_mult * d * self.moe_d_ff * experts + d * self.num_experts
                return attn + moe
            return attn + mlp
        if kind == "enc_attn":
            return attn + mlp
        if kind == "dense_mlp":
            return attn + mlp_mult * d * (self.first_dense_d_ff or self.d_ff)
        if kind == "ssm":
            din, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = din + 2 * self.ssm_groups * ns
            return (d * (2 * din + 2 * self.ssm_groups * ns + hs)
                    + self.ssm_conv * conv_dim + din * d + 2 * hs + din)
        if kind == "rglru":
            w = self.rnn_width
            return d * w * 2 + w * d + 4 * w + self.ssm_conv * w + mlp
        raise ValueError(kind)

    def max_position_actual(self) -> int:
        return self.decoder_max_len if self.encoder_layers else self.max_position
