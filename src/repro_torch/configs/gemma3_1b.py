"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1, head_dim 256)
d_ff=6912, vocab=262144, 5:1 local(512-window):global.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    sliding_window=512, local_global_ratio=5,
    qk_norm=True, rope_theta=1000000.0, mlp_act="gelu",
    tie_embeddings=True, scan_group=6,
)

SMOKE = ModelConfig(
    name="gemma3-smoke", family="dense",
    num_layers=8, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
    d_ff=128, vocab=128,
    sliding_window=8, local_global_ratio=5,
    qk_norm=True, mlp_act="gelu", tie_embeddings=True,
    scan_group=6, dtype="float32",
)
