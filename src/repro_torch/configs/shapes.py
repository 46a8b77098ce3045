"""Assigned input shapes x skip rules, and meta-tensor input specs.

Shapes (LM transformer family; seq_len x global_batch):
  train_4k     seq=4,096   gb=256   lowers train_step
  prefill_32k  seq=32,768  gb=32    lowers serve prefill
  decode_32k   seq=32,768  gb=128   lowers serve_step (1 new token, KV cache)
  long_500k    seq=524,288 gb=1     long-context decode

Skip rules (assignment):
  * long_500k needs sub-quadratic attention -> only ssm/hybrid run it.
  * encoder-only archs have no decode step -> decode_32k/long_500k skipped.

Where the JAX package returns `ShapeDtypeStruct`s, `input_specs` returns
tensors on the `meta` device: shape and dtype, no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def runnable(cfg: ModelConfig, shape_name: str) -> bool:
    sp = SHAPES[shape_name]
    if cfg.family == "encoder" and sp.kind == "decode":
        return False     # encoder-only: no decode step
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False     # quadratic-attention archs skip 500k decode
    return True


def cells_for(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if runnable(cfg, s)]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str, model=None) -> dict:
    """Meta-tensor stand-ins for every model input of the cell.

    For 'train': the loss_fn batch.  For 'prefill': the prompt batch.  For
    'decode': {tokens, cache} where cache comes from the family's
    abstract_cache.  No device allocation happens here.
    """
    sp = SHAPES[shape_name]
    b, s = sp.batch, sp.seq
    i32 = torch.int32
    act = getattr(torch, cfg.dtype)
    if sp.kind == "train":
        if cfg.family == "encoder":
            return {"frames": _meta((b, s, cfg.frame_dim), act),
                    "labels": _meta((b, s), i32)}
        if cfg.family == "vlm":
            s_txt = s - cfg.n_patches
            return {"tokens": _meta((b, s_txt), i32),
                    "patches": _meta((b, cfg.n_patches, cfg.patch_dim), act),
                    "labels": _meta((b, s_txt), i32)}
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if sp.kind == "prefill":
        if cfg.family == "encoder":
            return {"frames": _meta((b, s, cfg.frame_dim), act)}
        if cfg.family == "vlm":
            return {"tokens": _meta((b, s - cfg.n_patches), i32),
                    "patches": _meta((b, cfg.n_patches, cfg.patch_dim), act)}
        return {"tokens": _meta((b, s), i32)}
    # decode: one new token against a seq-long cache
    if model is None:
        raise ValueError("decode specs need the built model")
    cache = model.abstract_cache(b, s, cfg.dtype)
    return {"tokens": _meta((b,), i32), "cache": cache}
