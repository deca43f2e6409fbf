"""TinyLlama-1.1B [arXiv:2401.02385; hf]: llama2-arch small.
22L d_model=2048 32H GQA(kv=4) d_ff=5632 vocab=32000, SwiGLU, RoPE."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
        mlp_type="swiglu", norm_type="rmsnorm", tie_embeddings=False,
        logit_chunk=512, tensor_parallel=False)


def reduced() -> ModelConfig:
    return config().replace(name="tinyllama-reduced", n_layers=2,
                            d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
                            vocab_size=512, logit_chunk=0, attn_chunk=64)
