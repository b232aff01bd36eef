"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, vocab=65536; Mamba:attn 7:1 interleave, MoE 16e top-2 every
other layer.  [arXiv:2403.19887]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    mlp_act="silu", scan_group=8,
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128,
    n_experts=4, top_k=2, moe_every=2,
    attn_every=4, ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    mlp_act="silu", scan_group=4, dtype="float32", moe_capacity=8.0,
)
