"""whisper-medium [audio]: enc-dec transformer, conv frontend stubbed.

24L (enc) + 24L (dec) d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865 —
arXiv:2212.04356. ``input_specs`` provides precomputed frame embeddings
(B, 1500, d_model) in place of the mel+conv frontend.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, num_encoder_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
    mlp_act="gelu", encoder_seq=1500, max_seq_len=32768,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    num_layers=2, num_encoder_layers=2, d_model=128,
    num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
    mlp_act="gelu", encoder_seq=64, max_seq_len=128,
)
