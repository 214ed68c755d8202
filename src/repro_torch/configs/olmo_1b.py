"""olmo-1b [dense]: non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304 — arXiv:2402.00838.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304, nonparametric_norm=True,
    tie_embeddings=True, rope_theta=10000.0, max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="olmo-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512, nonparametric_norm=True,
    tie_embeddings=True, rope_theta=10000.0, max_seq_len=128,
)
