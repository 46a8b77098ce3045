"""deepseek-67b [dense] — llama architecture.
Source: arXiv:2401.02954 (hf tier).
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab=257, attn_chunk=16,
)
