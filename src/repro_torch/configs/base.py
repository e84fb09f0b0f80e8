"""Model/config schema for the assigned architecture pool.

One frozen dataclass covers every family (dense / moe / hybrid / ssm / vlm /
audio); family-specific fields are zero/None when unused.  Each
``configs/<arch>.py`` exports ``CONFIG`` (the exact published shape) and the
registry in ``configs/__init__.py`` resolves ``--arch`` ids.  ``reduced()``
yields the CPU-smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # --- attention pattern (gemma3 local:global striping) ---
    sliding_window: int = 0          # 0 = full attention
    local_per_global: int = 0        # e.g. 5 -> L,L,L,L,L,G repeating
    rope_theta_global: float = 0.0   # gemma3 uses 1M for global layers

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA (deepseek-v2) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    block_type: str = "attn"         # attn | mamba2 | rwkv6
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0       # zamba2: shared attn block every N layers

    # --- modality frontend stubs (vlm/audio) ---
    frontend: Optional[str] = None   # 'vision' | 'audio'
    n_media_tokens: int = 0

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.block_type in ("mamba2", "rwkv6") and \
            self.hybrid_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Archs eligible for the long_500k shape (ssm / hybrid)."""
        return self.block_type in ("mamba2", "rwkv6")

    def n_params(self) -> int:
        """Parameter count (used for MODEL_FLOPS = 6·N·D roofline term)."""
        d, l = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block_type == "attn" or self.hybrid_attn_every:
            if self.mla:
                q = d * self.q_lora_rank + self.q_lora_rank * self.n_heads \
                    * (self.qk_nope_dim + self.qk_rope_dim)
                kv = d * (self.kv_lora_rank + self.qk_rope_dim) \
                    + self.kv_lora_rank * self.n_heads \
                    * (self.qk_nope_dim + self.v_head_dim)
                o = self.n_heads * self.v_head_dim * d
                attn = q + kv + o
            else:
                attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
        else:
            attn = 0
        if self.block_type == "mamba2":
            d_in = self.ssm_expand * d
            # in_proj [d, 2*d_in + 2n + P] + out_proj [d_in, d] + conv
            p_heads = d_in // self.ssm_head_dim
            ssm = d * (2 * d_in + 2 * self.ssm_state + p_heads) \
                + d_in * d \
                + self.conv_kernel * (d_in + 2 * self.ssm_state)
        elif self.block_type == "rwkv6":
            lora = max(32, d // 16)
            # time-mix: 5 d·d (r,k,v,g,o) + decay lora; channel-mix:
            # w_r d·d + w_k d·F + w_v F·d
            ssm = 5 * d * d + 2 * d * lora + d * d + 2 * d * self.d_ff
        else:
            ssm = 0
        if self.is_moe:
            ff = self.n_experts * 3 * d * self.d_ff_expert \
                + self.n_shared_experts * 3 * d * self.d_ff_expert \
                + d * self.n_experts
        else:
            ff = 3 * d * self.d_ff
        if self.block_type == "attn":
            per_layer = attn + ff
        else:
            # ssm / rwkv blocks carry no separate SwiGLU (rwkv's
            # channel-mix is inside `ssm`; zamba2's MLP lives in the
            # shared attention block)
            per_layer = ssm
        total = emb + l * per_layer
        if self.hybrid_attn_every:
            # one shared attention block (+ its mlp), reused
            shared_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d + 3 * d * self.d_ff
            total += shared_attn
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k only)."""
        if not self.is_moe:
            return self.n_params()
        d, l = self.d_model, self.n_layers
        routed_all = self.n_experts * 3 * d * self.d_ff_expert
        routed_act = self.experts_per_token * 3 * d * self.d_ff_expert
        return int(self.n_params() - l * (routed_all - routed_act))

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 + (2 if self.hybrid_attn_every
                                             else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # no token dropping at smoke scale, so decode == forward exactly
            capacity_factor=float(min(self.n_experts, 4))
            / max(1, min(self.experts_per_token, 2)),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=64 if self.d_ff_expert else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=16 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32),
            hybrid_attn_every=min(self.hybrid_attn_every, 2)
            if self.hybrid_attn_every else 0,
            n_media_tokens=min(self.n_media_tokens, 8),
            dtype="float32",
        )


# ----------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
