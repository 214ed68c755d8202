"""llama3.2-3b [dense]: small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256 —
hf:meta-llama/Llama-3.2 family.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0,
    tie_embeddings=True, max_seq_len=8192,
)

SMOKE = ModelConfig(
    name="llama32-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, rope_theta=500000.0,
    tie_embeddings=True, max_seq_len=128,
)
