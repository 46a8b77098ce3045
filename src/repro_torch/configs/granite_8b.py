"""granite-8b [dense] — llama architecture, code model.
Source: arXiv:2405.04324 (hf tier).
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=257, attn_chunk=16,
)
