"""minicpm-2b [dense]: llama-like arch trained with the WSD schedule.

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753 — arXiv:2404.06395.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
    rope_theta=10000.0, max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="minicpm-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, tie_embeddings=True,
    rope_theta=10000.0, max_seq_len=128,
)
