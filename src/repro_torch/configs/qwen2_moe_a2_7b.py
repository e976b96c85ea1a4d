"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab_size=151936, rope_theta=1000000.0,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=5632),
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=48, vocab_size=256,
    moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=48,
                  n_shared_experts=2, d_ff_shared=96),
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
