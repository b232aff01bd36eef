"""Unified model configuration covering the 10 assigned architectures
(a copy of ``repro.models.config``: one name gives the same config in both
packages).

One dataclass parameterizes every family (dense / MoE / MLA / SSM / hybrid /
enc-dec / VLM-backbone); per-arch files in ``repro_torch/configs``
instantiate it with the published numbers and a reduced smoke variant.  The
port serves every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // num_heads

    # --- attention flavour ---
    qk_norm: bool = False                 # qwen3
    use_bias: bool = False                # command-r: no-bias (default off anyway)
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # gemma3 local layers
    local_global_ratio: int = 0           # gemma3: N local per 1 global
    attn_logit_softcap: Optional[float] = None
    mlp_act: str = "silu"                 # silu | squared_relu | gelu

    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None        # expert hidden size (deepseek fine-grained)
    moe_every: int = 1                    # apply MoE every k-th layer (jamba: 2)
    first_dense: int = 0                  # leading dense layers (deepseek: 1)
    moe_capacity: float = 1.25            # expert capacity factor

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0                    # d_state; 0 = no ssm layers
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_kernel: int = 4
    attn_every: int = 0                   # hybrid (jamba): 1 attn per k layers; 0 = per family

    # --- enc-dec (seamless backbone) ---
    enc_layers: int = 0                   # >0 => encoder-decoder
    cross_attention: bool = False

    # --- modality frontend stubs ---
    frontend: Optional[str] = None        # None | "vision" | "audio"
    frontend_tokens: int = 576            # patches / frames prepended (vlm/audio)

    # --- numerics / runtime ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_flash_attention: bool = False   # flash kernel (csrc/flash_attention.cu
                                        # on CUDA, its plain version on CPU)
    scan_group: int = 1                   # layers per scan body (pattern period)
    remat: bool = True                    # training only; no effect at inference
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 (16-way TP x 128 MXU lanes);
        logits beyond ``vocab`` are masked in ``logits_from_hidden``."""
        m = 2048
        return (self.vocab + m - 1) // m * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' for decoder layer idx (hybrid interleave)."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_every > 0:
            # jamba: 1 attention layer per attn_every layers (1:7 => every 8th)
            return "attn" if (idx % self.attn_every) == (self.attn_every - 1) else "ssm"
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        if idx < self.first_dense:
            return False
        return self.is_moe and (idx % self.moe_every) == (self.moe_every - 1)

    def layer_window(self, idx: int) -> Optional[int]:
        """Sliding window for layer idx (gemma3 5:1 local:global)."""
        if self.sliding_window is None:
            return None
        if self.local_global_ratio <= 0:
            return self.sliding_window
        period = self.local_global_ratio + 1
        return None if (idx % period) == (period - 1) else self.sliding_window

    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # mostly-local attention (gemma3) qualifies: global KV is 1/period
        return self.sliding_window is not None and self.local_global_ratio > 0

    # ---- parameter counting (for roofline MODEL_FLOPS) ----
    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, embeddings included."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        total = active = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
            active += v * d

        def attn_params():
            if self.mla:
                q = d * (self.num_heads * (self.qk_nope_dim + self.qk_rope_dim))
                kv = d * (self.kv_lora_rank + self.qk_rope_dim)
                up = self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                o = self.num_heads * self.v_head_dim * d
                return q + kv + up + o
            q = d * self.num_heads * hd
            k = d * self.num_kv_heads * hd
            vv = d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + k + vv + o

        def mlp_params(ff):
            mult = 3 if self.mlp_act in ("silu", "gelu") else 2  # gated vs plain
            return mult * d * ff

        def ssm_params():
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            in_proj = d * (2 * d_in + 2 * self.ssm_state + nheads)
            conv = (d_in + 2 * self.ssm_state) * self.ssm_conv_kernel
            out = d_in * d
            return in_proj + conv + out + 2 * nheads  # + A, D, dt bias

        n_dec = self.num_layers
        for i in range(n_dec):
            kind = self.layer_kind(i)
            t = attn_params() if kind == "attn" else ssm_params()
            a = t
            if self.layer_is_moe(i):
                e = mlp_params(self.expert_d_ff)
                t += self.n_experts * e + self.n_shared_experts * e
                t += d * self.n_experts  # router
                a += (self.top_k + self.n_shared_experts) * e + d * self.n_experts
            else:
                t += mlp_params(f)
                a += mlp_params(f)
            total += t
            active += a
        if self.is_encdec:
            enc = self.enc_layers * (attn_params() + mlp_params(f))
            cross = n_dec * attn_params()
            total += enc + cross
            active += enc + cross
        return total, active
