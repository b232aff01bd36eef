"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728,
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000,
    mlp_act="squared_relu", scan_group=1,
)

SMOKE = ModelConfig(
    name="nemotron-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab=128,
    mlp_act="squared_relu", scan_group=1, dtype="float32",
)
