"""RecurrentGemma-9B [arXiv:2402.19427; unverified]: Griffin hybrid —
RG-LRU recurrent blocks + local attention, 1 attention : 2 recurrent.
38L d_model=4096 16H MQA(kv=1) d_ff=12288 window=2048 vocab=256000.
Port of `repro.configs.recurrentgemma_9b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="rglru", n_layers=38,
        d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
        vocab_size=256000, mlp_type="geglu", norm_type="rmsnorm",
        block_pattern=("rg_rec", "rg_rec", "rg_attn"), lru_width=4096,
        local_window=2048, conv_width=4,
        tie_embeddings=True, logit_chunk=256, train_microbatches=8)


def reduced() -> ModelConfig:
    return config().replace(name="recurrentgemma-reduced", n_layers=3,
                            d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
                            lru_width=128, local_window=32, vocab_size=512,
                            logit_chunk=0, train_microbatches=1, attn_chunk=64)
