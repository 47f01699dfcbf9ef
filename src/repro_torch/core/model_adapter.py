"""Adapter: ModelConfig -> OffloadableModel for SSD-offloaded cached decode.

Port of the dense path of ``src/repro/core/model_adapter.py``.  The
session streams *unstacked* per-block parameter dicts (one block on the
device at a time); this adapter builds them and wires the applies the
session runs per unit.  Restrictions, as in the reference: the config must
be layer-homogeneous (period 1).  This port covers attention mixers with
dense FFNs; other families raise and name the slice that brings them.

Two ways in, one set of applies:

* :func:`make_offloadable_lm` draws fresh fp32 weights from a
  ``torch.Generator`` (or a seed),
* :func:`from_numpy_units` takes existing units by duck type (``.name``,
  ``.kind``, ``.params`` of numpy arrays) — the reference package's
  ``make_offloadable_lm`` emits exactly these, so both packages can start
  from the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import gqa_prefill, gqa_step
from repro_torch.models.layers import (embed_lookup, fan_in_init, lm_logits,
                                       rms_norm, trunc_normal)
from repro_torch.models.transformer import (LATER, apply_ffn, ffn_kind,
                                            init_layer_params, layer_period,
                                            mixer_kind)
from .offload_engine import OffloadableModel, OffloadUnit


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card
    raises (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda is not "
                           f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _kinds(cfg: ModelConfig) -> tuple[str, str]:
    if layer_period(cfg) != 1:
        raise ValueError(
            f"{cfg.name}: offloaded models require layer-homogeneous "
            f"configs (period==1); got period={layer_period(cfg)}")
    kinds = (mixer_kind(cfg, 0), ffn_kind(cfg, 0))
    if kinds[0] != "attn":
        raise NotImplementedError(f"{cfg.name}: mixer {kinds[0]!r} {LATER}")
    if kinds[1] not in ("dense", "none"):
        raise NotImplementedError(f"{cfg.name}: ffn {kinds[1]!r} {LATER}")
    return kinds


def make_offloadable_lm(cfg: ModelConfig, generator_or_seed,
                        compute_dtype=torch.bfloat16, *,
                        device="cuda") -> OffloadableModel:
    """Fresh fp32 units drawn from ``generator_or_seed`` (a
    ``torch.Generator``, or an int seeding a CPU generator), with the
    applies running in ``compute_dtype`` on ``device``."""
    _kinds(cfg)
    dev = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = torch.Generator().manual_seed(int(generator_or_seed))

    def host(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    units = [OffloadUnit("embed", "standalone", {
        "embed": host(trunc_normal(gen, (cfg.vocab, cfg.d_model), 0.02))})]
    for i in range(cfg.n_layers):
        params = {k: host(v) for k, v in
                  init_layer_params(gen, cfg, i).items()}
        units.append(OffloadUnit(f"block_{i:03d}", "block", params))
    head_params = {"final_norm": np.zeros((cfg.d_model,), np.float32)}
    # tied embeddings share the table; an untied head projects its own
    head_params["head"] = (
        units[0].params["embed"].T.copy() if cfg.tie_embeddings
        else host(fan_in_init(gen, (cfg.d_model, cfg.vocab))))
    units.append(OffloadUnit("head", "standalone", head_params))
    return from_numpy_units(cfg, units, compute_dtype, device=dev)


def from_numpy_units(cfg: ModelConfig, units, compute_dtype=torch.bfloat16,
                     *, device="cuda") -> OffloadableModel:
    """An OffloadableModel over existing units (any objects with ``.name``,
    ``.kind`` and ``.params`` of numpy arrays), applies on ``device``."""
    kinds = _kinds(cfg)
    dev = resolve_device(device)
    own = [OffloadUnit(u.name, u.kind,
                       {k: np.asarray(v) for k, v in u.params.items()})
           for u in units]

    def embed_apply(params, tokens):
        return embed_lookup(params["embed"].to(compute_dtype), tokens,
                            scale=cfg.embed_scale)

    def head_logits(params, h):
        h = rms_norm(h, params["final_norm"].to(compute_dtype), cfg.rms_eps)
        return lm_logits(h, params["head"].to(compute_dtype))

    def block_prefill(params, h):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k, v = gqa_prefill(params, hn, cfg)
        return apply_ffn(cfg, kinds[1], params, h + mix), k, v

    def block_step(params, h, k_cache, v_cache, cache_len, *, chunk=None):
        # ``chunk`` keeps the attention reductions extent-invariant — see
        # gqa_step; the session passes its decode time-bucket size
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k_new, v_new = gqa_step(params, hn, cfg, k_cache, v_cache,
                                     cache_len, chunk=chunk)
        return apply_ffn(cfg, kinds[1], params, h + mix), k_new, v_new

    def kv_shape(batch: int, time: int) -> tuple:
        return (2, batch, time, cfg.n_kv_heads, cfg.head_dim)

    return OffloadableModel(units=own, embed_apply=embed_apply,
                            class_of=ModelConfig.class_of_param, device=dev,
                            head_logits=head_logits,
                            block_prefill=block_prefill,
                            block_step=block_step, kv_shape=kv_shape)
