"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab_size=100352, rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
