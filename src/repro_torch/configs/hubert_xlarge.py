"""hubert-xlarge [audio]: 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.
Encoder-only (bidirectional, no decode); the conv waveform frontend is a STUB --
``input_specs()`` provides precomputed frame embeddings. [arXiv:2106.07447; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280, n_heads=16,
    n_kv_heads=16, d_ff=5120, vocab_size=504, encoder_only=True,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=64, encoder_only=True,
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
