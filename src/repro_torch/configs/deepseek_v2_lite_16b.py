"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf]: MLA (kv_lora=512) + MoE
(2 shared + 64 routed, top-6, expert_ff=1408). 27L d_model=2048 16H
vocab=102400. First layer uses a dense FFN (d_ff=10944), as published.
Port of `repro.configs.deepseek_v2_lite_16b`."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27,
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
        vocab_size=102400, mlp_type="swiglu", norm_type="rmsnorm",
        n_experts=64, n_shared_experts=2, experts_per_token=6,
        moe_d_ff=1408, first_dense_layers=1,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        tie_embeddings=True, logit_chunk=512, train_microbatches=4)


def reduced() -> ModelConfig:
    return config().replace(name="deepseek-reduced", n_layers=3, d_model=128,
                            n_heads=4, n_kv_heads=4, d_ff=256, moe_d_ff=64,
                            n_experts=8, n_shared_experts=1,
                            experts_per_token=2, kv_lora_rank=32,
                            qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                            vocab_size=512, logit_chunk=0,
                            train_microbatches=1, attn_chunk=64)
