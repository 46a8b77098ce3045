"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
Source: arXiv:2405.21060 (unverified tier).
48L d_model=1024 (attn-free) vocab=50280, ssm_state=128."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=257, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=8, tie_embeddings=True,
)
