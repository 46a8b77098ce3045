"""qwen1.5-0.5b [dense] — QKV bias, tied embeddings.
Source: hf:Qwen/Qwen1.5-0.5B (hf tier).
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, qkv_bias=True, tie_embeddings=True,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=257, qkv_bias=True, tie_embeddings=True, attn_chunk=16,
)
