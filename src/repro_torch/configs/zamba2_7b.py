"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
Source: arXiv:2411.15242 (unverified tier).
81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, tie_embeddings=True,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=257, ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    shared_attn_every=2, tie_embeddings=True, attn_chunk=16,
)
