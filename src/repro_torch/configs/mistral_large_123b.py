"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified].
88L d_model=12288 96H GQA(kv=8) d_ff=28672 vocab=32768, SwiGLU, RoPE
theta 1e6, weights in bf16. Port of `repro.configs.mistral_large_123b`."""
import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88,
        d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
        vocab_size=32768, mlp_type="swiglu", norm_type="rmsnorm",
        rope_theta=1e6, tie_embeddings=False, logit_chunk=512,
        train_microbatches=8, param_dtype=torch.bfloat16)


def reduced() -> ModelConfig:
    return config().replace(name="mistral-large-reduced", n_layers=2,
                            d_model=192, n_heads=12, n_kv_heads=2, d_ff=448,
                            vocab_size=512, logit_chunk=0,
                            train_microbatches=1, attn_chunk=64)
