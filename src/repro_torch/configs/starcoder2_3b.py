"""StarCoder2-3B [arXiv:2402.19173; hf]: GQA, RoPE, code.
30L d_model=3072 24H GQA(kv=2) d_ff=12288 (4x GELU) vocab=49152,
LayerNorm, rope theta 1e5, tied head. Port of `repro.configs.starcoder2_3b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
        n_heads=24, n_kv_heads=2, d_ff=12288, vocab_size=49152,
        mlp_type="gelu", norm_type="layernorm", rope_theta=1e5,
        tie_embeddings=True, logit_chunk=512, train_microbatches=1)


def reduced() -> ModelConfig:
    return config().replace(name="starcoder2-reduced", n_layers=2,
                            d_model=128, n_heads=8, n_kv_heads=2, d_ff=512,
                            vocab_size=512, logit_chunk=0,
                            train_microbatches=1, attn_chunk=64)
