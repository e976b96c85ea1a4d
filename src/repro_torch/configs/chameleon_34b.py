"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.
Early-fusion VLM: VQ image tokens share the text vocab; the modality frontend is a
STUB -- ``input_specs()`` provides precomputed patch/VQ token embeddings.
[arXiv:2405.09818; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab_size=65536, qk_norm=True,
)

SMOKE = ModelConfig(
    name="chameleon-smoke", family="vlm", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=160, vocab_size=256, qk_norm=True,
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
