"""grok-1-314b [moe]: 8-expert top-2 MoE.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072 — hf:xai-org/grok-1.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    num_experts=8, top_k=2, moe_d_ff=32768,
    max_seq_len=8192,
)

SMOKE = ModelConfig(
    name="grok-smoke", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    num_experts=4, top_k=2, moe_d_ff=256,
    max_seq_len=128,
)
