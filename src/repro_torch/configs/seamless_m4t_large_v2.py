"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d_model=1024 16H (kv=16) d_ff=8192, vocab=256206; speech frontend is a
STUB providing precomputed frame embeddings.  [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    enc_layers=24, cross_attention=True,
    frontend="audio", frontend_tokens=1024,
    mlp_act="gelu", scan_group=1,
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab=128,
    enc_layers=2, cross_attention=True,
    frontend="audio", frontend_tokens=8,
    mlp_act="gelu", scan_group=1, dtype="float32",
)
