"""mamba2-130m [ssm]: 24L d_model=768, attn-free SSD, vocab=50280,
d_state=128.  [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, scan_group=1,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
    d_ff=0, vocab=128,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=True, scan_group=1, dtype="float32",
)
