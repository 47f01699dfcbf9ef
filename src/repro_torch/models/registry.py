"""Model registry: one interface over the architectures the port runs.

Port of ``src/repro/models/registry.py``.  ``build(cfg)`` returns a
:class:`ModelImpl` bundling init / train-loss / prefill / decode functions
plus ``input_specs``, the batch's ``(shape, dtype)`` records
(:class:`TensorSpec`, the port's stand-in for ``jax.ShapeDtypeStruct``)
for each assigned input shape.

Decode semantics per family:

* attention families — KV cache (rolling window when sliding_window>0),
* MLA — compressed-latent cache,
* ``long_500k`` on dense/MoE/VLM/hybrid archs uses the sliding-window
  variant (window :data:`LONG_CONTEXT_WINDOW`), applied by
  :func:`variant_for_shape`.

Whisper (the audio family) and the Mamba/xLSTM mixers come with a later
slice: ``build`` refuses the audio family, and the other mixers raise at
their first use.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from . import transformer as tfm
from .layers import resolve_device

LONG_CONTEXT_WINDOW = 8192


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of an input, allocation-free."""
    shape: tuple
    dtype: torch.dtype


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Config variant actually run for a given input shape."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm") \
            and not cfg.sliding_window:
        # sub-quadratic requirement: sliding-window variant of the dense arch
        return replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    if shape.name == "long_500k" and cfg.family == "hybrid" \
            and not cfg.sliding_window:
        # hybrid: mamba layers are native; window the sparse attention layers
        return replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def shape_supported(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason-if-not).  The documented skips."""
    if cfg.family == "audio" and shape.name == "long_500k":
        return False, ("whisper is an enc-dec audio model with an "
                       "architectural decoder cap (~448 tokens); no "
                       "sub-quadratic 500k-context variant exists")
    return True, ""


@dataclass
class ModelImpl:
    cfg: ModelConfig
    init_params: Callable          # (generator or seed) -> params
    loss_fn: Callable              # (params, batch) -> scalar
    prefill_fn: Callable           # (params, batch) -> logits
    init_cache: Callable           # (batch, cache_seq, dtype) -> cache
    decode_fn: Callable            # (params, cache, tokens, cache_len)
    input_specs: Callable          # (shape) -> batch dict of TensorSpec

    def decode_args_specs(self, shape: InputShape, dtype=torch.bfloat16):
        """(cache_specs, tokens_spec, cache_len_spec) of a serve step."""
        cache = tfm.init_cache(self.cfg, shape.global_batch, shape.seq_len,
                               dtype, device="meta")
        cache_specs = tuple({k: TensorSpec(tuple(v.shape), v.dtype)
                             for k, v in c.items()} for c in cache)
        return (cache_specs,
                TensorSpec((shape.global_batch, 1), torch.int32),
                TensorSpec((), torch.int32))


def _lm_input_specs(cfg: ModelConfig, shape: InputShape,
                    compute_dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.prefix_len:
        specs["image_embeds"] = TensorSpec((b, cfg.prefix_len, cfg.d_model),
                                           compute_dtype)
        s = s - cfg.prefix_len      # image tokens count toward the context
    specs["tokens"] = TensorSpec((b, s), torch.int32)
    specs["labels"] = TensorSpec((b, s), torch.int32)
    return specs


def build(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
          remat: bool = True, bf16_logits: bool = False,
          device="cuda") -> ModelImpl:
    """The resident model's functions for ``cfg`` on ``device`` (where
    ``init_params`` draws from a seed and ``init_cache`` allocates)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: whisper (the audio family) is not ported yet; it "
            f"comes with a later model-zoo slice")
    dev = resolve_device(device)

    def loss_fn(params, batch):
        return tfm.lm_loss(cfg, params, batch, compute_dtype=compute_dtype,
                           remat=remat, bf16_logits=bf16_logits)

    def prefill_fn(params, batch):
        h = tfm.embed_tokens(cfg, params, batch["tokens"], compute_dtype)
        prefix = 0
        if cfg.prefix_len:
            h = torch.cat([batch["image_embeds"].to(compute_dtype), h],
                          dim=1)
            prefix = cfg.prefix_len
        h, _ = tfm.forward(cfg, params, h, prefix_len=prefix, remat=remat)
        logits = tfm.logits_fn(cfg, params, h)
        return logits.to(torch.bfloat16) if bf16_logits else logits

    return ModelImpl(
        cfg=cfg,
        init_params=lambda generator_or_seed: tfm.init_params(
            generator_or_seed, cfg, device=dev),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        init_cache=lambda b, s, dtype=torch.bfloat16:
            tfm.init_cache(cfg, b, s, dtype, device=dev),
        decode_fn=lambda params, cache, tokens, cache_len:
            tfm.decode_step(cfg, params, cache, tokens, cache_len,
                            compute_dtype=compute_dtype),
        input_specs=lambda shape: _lm_input_specs(cfg, shape, compute_dtype),
    )
