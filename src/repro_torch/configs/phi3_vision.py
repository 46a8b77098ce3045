"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub.
Source: hf:microsoft/Phi-3-vision-128k-instruct (hf tier).
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.  The CLIP tower is a
STUB: input_specs() provides precomputed patch embeddings
(n_patches=576, patch_dim=1024)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, n_patches=576, patch_dim=1024,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="phi3v-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=257, n_patches=4, patch_dim=16, attn_chunk=16,
)
