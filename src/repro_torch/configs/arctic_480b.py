"""arctic-480b [moe]: 128-expert top-2 MoE with dense residual FFN.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 —
hf:Snowflake/snowflake-arctic-base (dense-MoE hybrid: dense FFN residual in
parallel with the MoE branch).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    num_experts=8, top_k=2, moe_d_ff=256, dense_residual=True,
    max_seq_len=128,
)
