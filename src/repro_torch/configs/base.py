"""Model and shape configuration dataclasses (plain data, no framework)."""

from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # "dense" | "moe" | "encdec" | "hybrid" | "ssm"
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # expert hidden size (0 -> d_ff)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0   # apply shared attn block every N ssm layers
    # --- enc-dec (whisper) ---
    num_encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper: 30s audio -> 1500 frames
    # --- misc ---
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    qk_norm: bool = False         # chameleon
    nonparametric_norm: bool = False  # olmo
    mlp_act: str = "swiglu"       # "swiglu" | "gelu"
    dtype: str = "bfloat16"
    # quantization grouping
    quant_group: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k is runnable."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (matches init; used for 6ND roofline)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qk_norm:
            attn += 2 * hd
        mlp = 3 * d * f if self.mlp_act == "swiglu" else 2 * d * f
        norms = 0 if self.nonparametric_norm else 2 * d
        tied = self.tie_embeddings or self.family in ("encdec", "hybrid",
                                                      "ssm")
        if self.family in ("dense",):
            per_layer = attn + mlp + norms
            layers = self.num_layers * per_layer
        elif self.family == "moe":
            ef = self.expert_d_ff
            moe = self.num_experts * 3 * d * ef + d * self.num_experts
            dense = 3 * d * f if self.dense_residual else 0
            per_layer = attn + moe + dense + norms
            layers = self.num_layers * per_layer
        elif self.family == "encdec":
            enc_layer = attn + 2 * d * f + 2 * d            # gelu mlp
            dec_layer = attn + attn + 2 * d * f + 3 * d     # self+cross+3 LN
            layers = (self.num_encoder_layers * enc_layer
                      + self.num_layers * dec_layer)
        elif self.family in ("ssm", "hybrid"):
            di, ns, ng = self.d_inner, self.ssm_state, self.ssm_ngroups
            nh_s = self.ssm_nheads
            conv_ch = di + 2 * ng * ns
            in_proj = d * (2 * di + 2 * ng * ns + nh_s)
            per_layer = (in_proj + di * d + (self.ssm_conv + 1) * conv_ch
                         + 3 * nh_s + di
                         + (0 if self.nonparametric_norm else d))
            layers = self.num_layers * per_layer
            if self.family == "hybrid":
                layers += attn + mlp + 2 * d  # one shared block
        else:
            raise ValueError(self.family)
        embed = v * d
        head = 0 if tied else v * d
        if self.family == "encdec":
            final_norm = 2 * d  # enc_norm + dec norm
        else:
            final_norm = 0 if self.nonparametric_norm else d
        return layers + embed + head + final_norm

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ef = self.d_model, self.expert_d_ff
        inactive = (self.num_experts - self.top_k) * 3 * d * ef * self.num_layers
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
