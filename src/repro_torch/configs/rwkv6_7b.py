"""RWKV6 "Finch" 7B [arXiv:2404.05892; hf]: attention-free, data-dependent
decay. 32L d_model=4096 d_ff=14336 (channel-mix) vocab=65536, head_size=64
(64 wkv heads). Port of `repro.configs.rwkv6_7b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="rwkv6", n_layers=32, d_model=4096,
        n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536,
        head_size=64, decay_lora=64, use_rope=False, norm_type="layernorm",
        tie_embeddings=True, logit_chunk=512, train_microbatches=2)


def reduced() -> ModelConfig:
    return config().replace(name="rwkv6-reduced", n_layers=2, d_model=128,
                            n_heads=4, n_kv_heads=4, head_size=32,
                            decay_lora=16, d_ff=256, vocab_size=512,
                            logit_chunk=0, train_microbatches=1, mixer_chunk=8)
