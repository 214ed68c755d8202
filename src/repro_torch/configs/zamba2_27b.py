"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64 —
arXiv:2411.15242. One shared attn+MLP block applied every 6 Mamba2 layers
(9 sites); per-site LoRA adapters omitted (docs/DESIGN.md §2.1).
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    shared_attn_period=6, rope_theta=10000.0, max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1,
    shared_attn_period=2, rope_theta=10000.0, max_seq_len=128,
    ssm_chunk=32,
)
