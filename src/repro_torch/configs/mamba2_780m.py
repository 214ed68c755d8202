"""mamba2-780m [ssm]: attention-free SSD (state-space duality) LM.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128 — arXiv:2405.21060.
"""

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1,
    max_seq_len=8192,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_ngroups=1,
    max_seq_len=128, ssm_chunk=32,
)
