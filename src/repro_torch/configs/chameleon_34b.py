"""chameleon-34b [vlm]: early-fusion VLM backbone, VQ image tokens in vocab.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 — arXiv:2405.09818.
The VQ-VAE image tokenizer is a stub: image tokens are ordinary vocab ids
(early fusion), so ``input_specs`` is a plain token batch. QK-norm per the
Chameleon recipe.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="chameleon-34b", family="dense",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22016, vocab_size=65536, qk_norm=True, rope_theta=10000.0,
    max_seq_len=4096,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, qk_norm=True, rope_theta=10000.0,
    max_seq_len=128,
)
