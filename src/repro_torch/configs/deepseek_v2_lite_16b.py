"""deepseek-v2-lite-16b [moe]: 27L d_model=2048, MLA kv_lora=512,
2 shared + 64 routed experts top-6 (expert_ff=1408), first layer dense.
[arXiv:2405.04434]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab=102400,
    mla=True, kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    moe_every=1, first_dense=1, mlp_act="silu", scan_group=1,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="moe",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab=128,
    mla=True, kv_lora_rank=32, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
    n_experts=4, n_shared_experts=1, top_k=2, moe_d_ff=32,
    moe_every=1, first_dense=1, mlp_act="silu", scan_group=1, dtype="float32", moe_capacity=8.0,
)
