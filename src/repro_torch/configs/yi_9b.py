"""yi-9b [dense]: llama-arch GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 — arXiv:2403.04652.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=10000.0, max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="yi-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, rope_theta=10000.0, max_seq_len=128,
)
