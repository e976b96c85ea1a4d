"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention blocks every 6 layers.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256,
                  attn_every=6),
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32,
                  attn_every=2),
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
