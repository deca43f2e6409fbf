"""DBRX-132B [hf:databricks/dbrx-base; unverified]: fine-grained MoE.
40L d_model=6144 48H GQA(kv=8) 16 experts top-4 expert_ff=10752
vocab=100352, GLU experts, RoPE, LayerNorm, weights in bf16. Port of
`repro.configs.dbrx_132b`."""
import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab_size=100352,
        mlp_type="swiglu", norm_type="layernorm",
        n_experts=16, experts_per_token=4, moe_d_ff=10752,
        rope_theta=5e5, tie_embeddings=True, logit_chunk=512,
        train_microbatches=8, param_dtype=torch.bfloat16)


def reduced() -> ModelConfig:
    return config().replace(name="dbrx-reduced", n_layers=2, d_model=128,
                            n_heads=8, n_kv_heads=2, d_ff=256, moe_d_ff=256,
                            n_experts=4, experts_per_token=2, vocab_size=512,
                            logit_chunk=0, train_microbatches=1, attn_chunk=64)
