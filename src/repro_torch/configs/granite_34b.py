"""granite-34b [dense] — llama architecture (MQA kv=1), code model.
Source: arXiv:2405.04324 (hf tier).
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152,
    mlp_gated=False,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_ff=192,
    vocab=257, attn_chunk=16,
)
