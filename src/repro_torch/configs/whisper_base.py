"""Whisper-base [arXiv:2212.04356; unverified]: encoder-decoder; the conv
front end is a stub (the batch carries precomputed frame embeddings,
"frames"). 6+6L d_model=512 8H d_ff=2048 vocab=51865, sinusoidal positions
in the encoder, GELU, LayerNorm. Port of `repro.configs.whisper_base`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec", n_layers=6, n_enc_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=51865,
        mlp_type="gelu", norm_type="layernorm", use_rope=False,
        frontend="audio", tie_embeddings=True, logit_chunk=512,
        tensor_parallel=False)


def reduced() -> ModelConfig:
    return config().replace(name="whisper-reduced", n_layers=2,
                            n_enc_layers=2, d_model=128, n_heads=4,
                            n_kv_heads=4, d_ff=256, vocab_size=512,
                            logit_chunk=0, attn_chunk=64)
