"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) expert_ff=10752,
vocab=100352, 16 experts top-4.  [hf:databricks/dbrx-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, moe_every=1, mlp_act="silu",
    rope_theta=500000.0, scan_group=1,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab=128,
    n_experts=4, top_k=2, moe_every=1, mlp_act="silu",
    scan_group=1, dtype="float32", moe_capacity=8.0,
)
