"""hubert-xlarge [audio/encoder] — encoder-only, w2v2 architecture.
Source: arXiv:2106.07447 (unverified tier).
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.  The conv waveform
frontend is a STUB: input_specs() provides precomputed frame embeddings
(frame_dim=512, the frontend's output width)."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, frame_dim=512,
    mlp_gated=False,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="encoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=61, frame_dim=24, attn_chunk=16,
)
