"""Adapter: ModelConfig -> OffloadableModel for SSD-offloaded training and
cached decode.

Port of ``src/repro/core/model_adapter.py``.  The session streams
*unstacked* per-block parameter dicts (one block on the device at a time);
this adapter builds them and wires the applies the session runs per unit.
Restrictions, as in the reference: the config must be layer-homogeneous
(period 1).  This port covers attention mixers with dense or MoE FFNs;
other mixers raise and name the slice that brings them.

Expert paging (``expert_paging="all" | "routed"``) splits each MoE block's
stacked ``(E, ...)`` expert tensors into per-expert params
``moe.expert{x}.w_{gate,up,down}`` (pages of the session's expert page
cache) and wires the split applies: ``block_route`` (mixer + router
top-k), ``block_moe`` (the routed FFN over staged expert stacks, the
routing pinned) and ``block_moe_bwd`` (the whole block recomputed under
autograd with the routing pinned), plus the cached-decode route variants.

Two ways in, one set of applies:

* :func:`make_offloadable_lm` draws fresh fp32 weights from a
  ``torch.Generator`` (or a seed),
* :func:`from_numpy_units` takes existing units by duck type (``.name``,
  ``.kind``, ``.params`` of numpy arrays) — the reference package's
  ``make_offloadable_lm`` emits exactly these, so both packages can start
  from the same bytes.  Units that carry per-expert pages (the
  reference's ``expert_paging=`` units) rebuild ``expert_meta`` from
  their parameter names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (gqa_attention, gqa_prefill,
                                          gqa_step, gqa_verify)
from repro_torch.models.layers import (cross_entropy, dense, embed_lookup,
                                       fan_in_init, lm_logits, rms_norm,
                                       split_positions, trunc_normal)
from repro_torch.models.moe import moe_ffn, ordered_top_k
from repro_torch.models.transformer import (LATER, apply_ffn, apply_layer,
                                            ffn_kind, init_layer_params,
                                            layer_period, mixer_kind)
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
    return kinds


def _expert_names(x: int) -> tuple[str, str, str]:
    return (f"moe.expert{x}.w_gate", f"moe.expert{x}.w_up",
            f"moe.expert{x}.w_down")


def _split_experts(cfg: ModelConfig, params: dict) -> dict:
    """One MoE block's params with the stacked ``(E, ...)`` expert tensors
    split into per-expert params (the reference's paged layout)."""
    params = dict(params)
    stacks = [params.pop(k) for k in ("moe.w_gate", "moe.w_up",
                                      "moe.w_down")]
    for x in range(cfg.moe.n_experts):
        for name, stack in zip(_expert_names(x), stacks, strict=True):
            params[name] = np.ascontiguousarray(stack[x])
    return params


def _expert_meta(cfg: ModelConfig, units) -> dict | None:
    """``expert_meta`` of units that carry per-expert pages (None when
    none does): unit name -> {"n_experts", "experts": name triples}."""
    paged = [u.name for u in units if _expert_names(0)[0] in u.params]
    if not paged:
        return None
    e = cfg.moe.n_experts
    return {name: {"n_experts": e,
                   "experts": [_expert_names(x) for x in range(e)]}
            for name in paged}


def make_offloadable_lm(cfg: ModelConfig, generator_or_seed,
                        compute_dtype=torch.bfloat16, *,
                        device="cuda",
                        expert_paging: str = "off") -> OffloadableModel:
    """Fresh fp32 units drawn from ``generator_or_seed`` (a
    ``torch.Generator``, or an int seeding a CPU generator), with the
    applies running in ``compute_dtype`` on ``device``.  With
    ``expert_paging`` "all" or "routed" each MoE block's expert stacks
    are split into per-expert pages (the policy's ``expert_paging`` must
    then name the same residency family)."""
    kinds = _kinds(cfg)
    if expert_paging not in ("off", "all", "routed"):
        raise ValueError(f"expert_paging must be 'off'|'all'|'routed', got "
                         f"{expert_paging!r}")
    if expert_paging != "off" and kinds[1] != "moe":
        raise ValueError(f"{cfg.name}: expert_paging={expert_paging!r} "
                         f"needs a MoE config (ffn kind is {kinds[1]!r})")
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
        if expert_paging != "off":
            params = _split_experts(cfg, params)
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
    ``.kind`` and ``.params`` of numpy arrays), applies on ``device``.
    Units holding per-expert pages get the expert-paged applies."""
    kinds = _kinds(cfg)
    dev = resolve_device(device)
    own = [OffloadUnit(u.name, u.kind,
                       {k: np.asarray(v) for k, v in u.params.items()})
           for u in units]
    expert_meta = _expert_meta(cfg, own)

    def embed_apply(params, tokens):
        return embed_lookup(params["embed"].to(compute_dtype), tokens,
                            scale=cfg.embed_scale)

    def block_apply(params, h):
        return apply_layer(cfg, kinds, params, h)

    def head_logits(params, h):
        h = rms_norm(h, params["final_norm"].to(compute_dtype), cfg.rms_eps)
        return lm_logits(h, params["head"].to(compute_dtype))

    def head_loss(params, h, labels):
        return cross_entropy(head_logits(params, h), labels)

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

    def block_verify(params, h, k_cache, v_cache, cache_len, *,
                     chunk=None):
        # a (B, K) draft window in one weight fetch: every norm, projection
        # and FFN runs per position at block_step's (B, 1) shapes, so the
        # window is bitwise K chained block_steps (see gqa_verify)
        cols = split_positions(h)
        hn = torch.cat([rms_norm(c, params["norm_mixer"], cfg.rms_eps)
                        for c in cols], dim=1)
        mix, k_new, v_new = gqa_verify(params, hn, cfg, k_cache, v_cache,
                                       cache_len, chunk=chunk)
        out = [apply_ffn(cfg, kinds[1], params, c + m)
               for c, m in zip(cols, split_positions(mix), strict=True)]
        return torch.cat(out, dim=1), k_new, v_new

    def kv_shape(batch: int, time: int) -> tuple:
        return (2, batch, time, cfg.n_kv_heads, cfg.head_dim)

    paged = {} if expert_meta is None else _paged_applies(cfg)
    return OffloadableModel(units=own, embed_apply=embed_apply,
                            class_of=ModelConfig.class_of_param, device=dev,
                            block_apply=block_apply, head_loss=head_loss,
                            head_logits=head_logits,
                            block_prefill=block_prefill,
                            block_step=block_step, block_verify=block_verify,
                            kv_shape=kv_shape, expert_meta=expert_meta,
                            **paged)


def _paged_applies(cfg: ModelConfig) -> dict:
    """The expert-paged applies of a MoE block: a routing half (the mixer
    and the router's top-k, whose indices the host reads back to decide
    which expert pages to fetch) and an expert half (the routed FFN over
    staged (E, ...) stacks whose unrouted rows are zero and never read by
    moe_ffn's dispatch or combine, so routed and all-resident residency
    give the same bits).  The backward recomputes the whole block under
    autograd with the forward's expert indices pinned."""

    def route_idx(params, hmid):
        # the logits moe_ffn recomputes; only the top-k indices go on to
        # the host's fetch decision
        hn = rms_norm(hmid, params["norm_ffn"], cfg.rms_eps)
        b, s, d = hn.shape
        logits = dense(hn.reshape(b * s, d), params["moe.w_router"])
        return ordered_top_k(torch.softmax(logits.float(), dim=-1),
                             cfg.moe.top_k)[1]

    def mixer_half(params, h):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        return h + gqa_attention(params, hn, cfg)

    def block_route(params, h):
        hmid = mixer_half(params, h)
        return hmid, route_idx(params, hmid)

    def block_moe(params, gate, up, down, idx, hmid):
        # apply_ffn's MoE half with the expert stacks passed in (staged
        # from the page cache) and the routing pinned to the route stage's
        hn = rms_norm(hmid, params["norm_ffn"], cfg.rms_eps)
        full = {**params, "moe.w_gate": gate, "moe.w_up": up,
                "moe.w_down": down}
        out, _aux = moe_ffn(full, hn, cfg, idx=idx)
        return hmid + out

    def block_moe_bwd(params, gate, up, down, idx, h, dh):
        # recompute the block from its checkpoint under autograd, with the
        # forward's expert assignment pinned so the staged stacks cover
        # every expert the backward touches
        with torch.enable_grad():
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            stacks = [t.detach().requires_grad_() for t in (gate, up, down)]
            x = h.detach().requires_grad_()
            out = block_moe(p, *stacks, idx, mixer_half(p, x))
            keys = list(p)
            grads = torch.autograd.grad(
                out, [p[k] for k in keys] + stacks + [x], grad_outputs=dh)
        n = len(keys)
        return (dict(zip(keys, grads[:n], strict=True)), *grads[n:])

    def block_prefill_route(params, h):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k, v = gqa_prefill(params, hn, cfg)
        hmid = h + mix
        return hmid, k, v, route_idx(params, hmid)

    def block_step_route(params, h, k_cache, v_cache, cache_len, *,
                         chunk=None):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k_new, v_new = gqa_step(params, hn, cfg, k_cache, v_cache,
                                     cache_len, chunk=chunk)
        hmid = h + mix
        return hmid, k_new, v_new, route_idx(params, hmid)

    def block_verify_route(params, h, k_cache, v_cache, cache_len, *,
                           chunk=None):
        # block_verify's mixer half: norms and routing per position, at
        # the step's (B, 1) shapes, so the window is bitwise K steps
        cols = split_positions(h)
        hn = torch.cat([rms_norm(c, params["norm_mixer"], cfg.rms_eps)
                        for c in cols], dim=1)
        mix, k_new, v_new = gqa_verify(params, hn, cfg, k_cache, v_cache,
                                       cache_len, chunk=chunk)
        hmid = [c + m for c, m in zip(cols, split_positions(mix),
                                      strict=True)]
        idx = torch.stack([route_idx(params, hj) for hj in hmid], dim=1)
        return torch.cat(hmid, dim=1), k_new, v_new, idx

    return {"block_route": block_route, "block_moe": block_moe,
            "block_moe_bwd": block_moe_bwd,
            "block_prefill_route": block_prefill_route,
            "block_step_route": block_step_route,
            "block_verify_route": block_verify_route}
