"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=6144, vocab_size=151936, qk_norm=True,
    rope_theta=1000000.0, d_head=128,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, qk_norm=True, d_head=16,
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
