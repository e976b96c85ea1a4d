"""internlm-1.8b [dense]: paper's own small eval model (InternLM2-1.8B proxy):
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544. [hf:internlm/internlm2-1_8b]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm-1.8b", family="dense", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab_size=92544, rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="internlm-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256,
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
