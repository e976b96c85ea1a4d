"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense", n_layers=30, d_model=576, n_heads=9,
    n_kv_heads=3, d_ff=1536, vocab_size=49152, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense", n_layers=2, d_model=48, n_heads=3,
    n_kv_heads=1, d_ff=128, vocab_size=256, tie_embeddings=True,
    attn_block_q=32, attn_block_k=32, loss_chunk=32,
)
