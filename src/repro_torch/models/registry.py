"""Model registry: one interface over the architectures the port runs.

Port of ``src/repro/models/registry.py``.  ``build(cfg)`` returns a
:class:`ModelImpl` bundling init / train-loss / prefill / decode functions
plus ``input_specs``, the batch's ``(shape, dtype)`` records
(:class:`TensorSpec`, the port's stand-in for ``jax.ShapeDtypeStruct``)
for each assigned input shape.

Decode semantics per family:

* attention families — KV cache (rolling window when sliding_window>0),
* MLA — compressed-latent cache,
* SSM / hybrid — constant-size recurrent state (+ KV for the attention
  layers of a hybrid),
* whisper (audio) — decoder self-attention KV + the cross K/V computed
  once from the encoder memory,
* ``long_500k`` on dense/MoE/VLM/hybrid archs uses the sliding-window
  variant (window :data:`LONG_CONTEXT_WINDOW`), applied by
  :func:`variant_for_shape`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from . import transformer as tfm
from . import whisper as whs
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
    init_cache: Callable           # (batch, cache_seq, dtype, device=)
    decode_fn: Callable            # (params, cache, tokens, cache_len)
    input_specs: Callable          # (shape) -> batch dict of TensorSpec

    def decode_args_specs(self, shape: InputShape, dtype=torch.bfloat16):
        """(cache_specs, tokens_spec, cache_len_spec) of a serve step: the
        cache tree's structure with a TensorSpec at each leaf, from the
        cache built on the meta device (no memory)."""
        cache = self.init_cache(shape.global_batch, shape.seq_len, dtype,
                                device="meta")
        return (_specs_of(cache),
                TensorSpec((shape.global_batch, 1), torch.int32),
                TensorSpec((), torch.int32))


def param_shapes(cfg: ModelConfig) -> dict:
    """``cfg``'s parameter tree on the meta device (shapes and dtypes, no
    memory): the counterpart of the reference's ``eval_shape`` of
    ``init_params``."""
    return build(cfg, device="meta").init_params(0)


def _specs_of(tree):
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs_of(v) for v in tree)
    return TensorSpec(tuple(tree.shape), tree.dtype)


def _lm_input_specs(cfg: ModelConfig, shape: InputShape,
                    compute_dtype=torch.bfloat16) -> dict:
    b, s = shape.global_batch, shape.seq_len
    specs = {}
    if cfg.family == "audio":
        specs["frames"] = TensorSpec((b, cfg.encoder_seq, cfg.d_model),
                                     compute_dtype)
    elif cfg.prefix_len:
        specs["image_embeds"] = TensorSpec((b, cfg.prefix_len, cfg.d_model),
                                           compute_dtype)
        s = s - cfg.prefix_len      # image tokens count toward the context
    specs["tokens"] = TensorSpec((b, s), torch.int32)
    specs["labels"] = TensorSpec((b, s), torch.int32)
    return specs


def build(cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
          remat: bool = True, bf16_logits: bool = False, hint=None,
          device="cuda") -> ModelImpl:
    """The resident model's functions for ``cfg`` on ``device`` (where
    ``init_params`` draws from a seed and ``init_cache`` allocates).
    ``hint`` re-asserts the activation sharding on a mesh after the
    embedding and every layer group (attention-family models; the audio
    family takes none, as in the reference)."""
    dev = resolve_device(device)
    if cfg.family == "audio":
        return _build_whisper(cfg, compute_dtype, remat, dev)

    def loss_fn(params, batch):
        return tfm.lm_loss(cfg, params, batch, compute_dtype=compute_dtype,
                           remat=remat, bf16_logits=bf16_logits, hint=hint)

    def prefill_fn(params, batch):
        h = tfm.embed_tokens(cfg, params, batch["tokens"], compute_dtype)
        prefix = 0
        if cfg.prefix_len:
            h = torch.cat([batch["image_embeds"].to(compute_dtype), h],
                          dim=1)
            prefix = cfg.prefix_len
        if hint is not None:
            h = hint(h)
        h, _ = tfm.forward(cfg, params, h, prefix_len=prefix, remat=remat,
                           hint=hint)
        logits = tfm.logits_fn(cfg, params, h)
        return logits.to(torch.bfloat16) if bf16_logits else logits

    return ModelImpl(
        cfg=cfg,
        init_params=lambda generator_or_seed: tfm.init_params(
            generator_or_seed, cfg, device=dev),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        init_cache=lambda b, s, dtype=torch.bfloat16, device=dev:
            tfm.init_cache(cfg, b, s, dtype, device=device),
        decode_fn=lambda params, cache, tokens, cache_len:
            tfm.decode_step(cfg, params, cache, tokens, cache_len,
                            compute_dtype=compute_dtype),
        input_specs=lambda shape: _lm_input_specs(cfg, shape, compute_dtype),
    )


def _build_whisper(cfg: ModelConfig, compute_dtype, remat: bool,
                   dev: torch.device) -> ModelImpl:
    """The audio family: whisper's encoder-decoder.  The serve step needs a
    cache whose cross K/V were filled by ``whisper.prefill_cross_cache``."""
    return ModelImpl(
        cfg=cfg,
        init_params=lambda generator_or_seed: whs.init_whisper_params(
            generator_or_seed, cfg, device=dev),
        loss_fn=lambda params, batch: whs.whisper_loss(
            cfg, params, batch, compute_dtype=compute_dtype, remat=remat),
        prefill_fn=lambda params, batch: whs.whisper_logits(
            cfg, params, batch, compute_dtype=compute_dtype, remat=remat),
        init_cache=lambda b, s, dtype=torch.bfloat16, device=dev:
            whs.init_whisper_cache(cfg, b, s, dtype, device=device),
        decode_fn=lambda params, cache, tokens, cache_len:
            whs.whisper_decode_step(cfg, params, cache, tokens, cache_len,
                                    compute_dtype=compute_dtype),
        input_specs=lambda shape: _lm_input_specs(cfg, shape, compute_dtype),
    )
