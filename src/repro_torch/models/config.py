"""Model configuration shared by every architecture family."""
from __future__ import annotations

import dataclasses


def pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int = 0
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # mlp
    d_ff: int = 0
    mlp_gated: bool = True       # SwiGLU (3 mats) vs GELU (2 mats)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_groups: int = 1
    # hybrid (zamba2): shared attention block cadence
    shared_attn_every: int = 6
    # modality stubs
    n_patches: int = 0           # vlm: CLIP patch count
    patch_dim: int = 0           # vlm: CLIP feature dim
    frame_dim: int = 0           # audio: frontend frame feature dim
    # misc
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 128
    # numerics / lowering
    dtype: str = "float32"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = False          # checkpoint each layer (dry-run/training)
    attn_chunk: int = 2048       # blocked-causal attention query-chunk size

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, self.vocab_pad_multiple) if self.vocab else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_causal(self) -> bool:
        return self.family != "encoder"

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND and the paper's tables)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_padded
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "encoder", "vlm"):
            att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.qkv_bias:
                att += self.n_heads * hd + 2 * self.n_kv_heads * hd
            mlp = (3 if self.mlp_gated else 2) * d * ff
            per = att + mlp + 2 * d
            extra = 0
            if self.family == "vlm":
                extra = self.patch_dim * d
            if self.family == "encoder":
                extra = self.frame_dim * d
            return emb + self.n_layers * per + d + extra
        if self.family == "moe":
            att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            moe = d * self.n_experts + self.n_experts * 3 * d * ff
            return emb + self.n_layers * (att + moe + 2 * d) + d
        if self.family == "ssm":
            per = self._mamba_block_params()
            return emb + self.n_layers * per + d
        if self.family == "hybrid":
            per = self._mamba_block_params()
            d2 = 2 * d
            shared = d2 + d2 * self.n_heads * hd + 2 * d2 * self.n_kv_heads * hd \
                + self.n_heads * hd * d + d + 3 * d * ff
            return emb + self.n_layers * per + shared + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        hd = self.hd
        att = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        moe_active = d * self.n_experts + self.top_k * 3 * d * ff
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (att + moe_active + 2 * d) + d

    def _mamba_block_params(self) -> int:
        d = self.d_model
        din = self.d_inner
        st = self.ssm_state
        nh = self.ssm_heads
        proj_in = d * (2 * din + 2 * self.ssm_groups * st + nh)
        conv = self.conv_width * (din + 2 * self.ssm_groups * st)
        return proj_in + conv + 3 * nh + din + din * d + d
