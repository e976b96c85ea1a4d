"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
Finch: data-dependent decay linear recurrence. [arXiv:2404.05892; hf]"""
from .base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560, n_heads=40,
    n_kv_heads=40, d_ff=8960, vocab_size=65536,
    # chunk=64: the intra-chunk pairwise decay tensor streams S*L*H*hd
    # elements per layer, linear in L; 256->64 cuts that memory term ~4x
    # at equal math (the reference's choice).
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk=64),
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256,
    rwkv=RWKVConfig(head_dim=16, decay_lora=16, chunk=32),
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
