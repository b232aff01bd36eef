"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480,
vocab=64000 text backbone; anyres vision frontend is a STUB providing
precomputed patch embeddings.  [hf:llava-hf/llava-v1.6-34b-hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    frontend="vision", frontend_tokens=576,
    mlp_act="silu", rope_theta=5000000.0, scan_group=1,
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128,
    frontend="vision", frontend_tokens=8,
    mlp_act="silu", scan_group=1, dtype="float32",
)
