"""Granite-20B-Code [arXiv:2405.04324; hf]: code model, MQA.
52L d_model=6144 48H GQA(kv=1) d_ff=24576 (4x, non-gated GELU) vocab=49152,
LayerNorm, tied head. Port of `repro.configs.granite_20b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, d_ff=24576, vocab_size=49152,
        mlp_type="gelu", norm_type="layernorm", tie_embeddings=True,
        logit_chunk=512, train_microbatches=4)


def reduced() -> ModelConfig:
    return config().replace(name="granite-reduced", n_layers=2, d_model=128,
                            n_heads=8, n_kv_heads=1, d_ff=512, vocab_size=512,
                            logit_chunk=0, train_microbatches=1, attn_chunk=64)
