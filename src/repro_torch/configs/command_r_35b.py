"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528,
vocab=256000, no-bias, tied embeddings.  [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000,
    mlp_act="silu", tie_embeddings=True, rope_theta=8000000.0, scan_group=1,
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128,
    mlp_act="silu", tie_embeddings=True, scan_group=1, dtype="float32",
)
