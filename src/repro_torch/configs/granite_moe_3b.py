"""granite-moe-3b-a800m [moe] — 40 experts top-8.
Source: hf:ibm-granite (hf tier).  Assignment inline spec: 32L d_model=1536
24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.  (The bracketed hf id
granite-3.0-1b-a400m and the '32 experts' prose disagree with the inline
numbers; the inline spec wins — see DESIGN.md §5.)"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=40, top_k=8, capacity_factor=1.25,
    dtype="bfloat16", param_dtype="float32", remat=True,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=257, n_experts=8, top_k=4, capacity_factor=2.0, attn_chunk=16,
)
