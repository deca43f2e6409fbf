"""PaliGemma-3B [arXiv:2407.07726; hf]: SigLIP vision front end (a stub:
the batch carries precomputed patch embeddings, "image_embeds", a prefix
the decoder attends to both ways) + gemma decoder. 18L d_model=2048 8H
GQA(kv=1) d_ff=16384 vocab=257216. Port of `repro.configs.paligemma_3b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, d_ff=16384, vocab_size=257216,
        mlp_type="geglu", norm_type="rmsnorm",
        frontend="vision", frontend_len=256,
        tie_embeddings=True, logit_chunk=256)


def reduced() -> ModelConfig:
    return config().replace(name="paligemma-reduced", n_layers=2,
                            d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
                            vocab_size=512, frontend_len=16, logit_chunk=0,
                            attn_chunk=64)
