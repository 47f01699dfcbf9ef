"""Adapter: ModelConfig -> OffloadableModel for SSD-offloaded training and
cached decode.

Port of ``src/repro/core/model_adapter.py``.  The session streams
*unstacked* per-block parameter dicts (one block on the device at a time);
this adapter builds them and wires the applies the session runs per unit.
Each block's (mixer, ffn) kinds come from that block's own parameters
(:func:`block_kinds`), so the layers need not be homogeneous, where the
reference asks for a period of 1: Kimi Linear's KDA and MLA blocks stream
through one plan, and leading dense layers ahead of a MoE period
(``first_dense_layers``) run the dense FFN and stream whole, never paged.
Every mixer (attention, MLA, KDA, Mamba, mLSTM, sLSTM) trains, evaluates
and runs uncached decode, with a dense or MoE FFN.  The cached-decode
applies (``block_prefill`` / ``block_step`` / ``block_verify``,
``kv_shape``) exist where every block is attention, as in the reference:
over an MLA latent, a KDA state or a recurrent state a ``DecodeSpec``
session raises, naming the mixers.

Expert paging (``expert_paging="all" | "routed"``) splits each MoE block's
stacked ``(E, ...)`` expert tensors into per-expert params
``moe.expert{x}.w_{gate,up,down}`` (pages of the session's expert page
cache) and wires the split applies: ``block_route`` (mixer + router
top-k), ``block_moe`` (the routed FFN over staged expert stacks, the
routing pinned) and ``block_moe_bwd`` (the whole block recomputed under
autograd with the routing pinned), plus the cached-decode route variants.

Two ways in, one set of applies:

* :func:`make_offloadable_lm` draws fresh weights from a
  ``torch.Generator`` (or a seed), one tensor at a time, each moved to
  the host as soon as it is drawn (fp32 masters, or bf16 bits for a
  serving-only model),
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
from repro_torch.models.attention import gqa_prefill, gqa_step, gqa_verify
from repro_torch.models.layers import (cross_entropy, embed_lookup,
                                       fan_in_init, lm_logits,
                                       resolve_device, rms_norm,
                                       split_positions, trunc_normal)
from repro_torch.models.moe import (_capacity, moe_ffn, route_top_k,
                                    router_logits)
from repro_torch.models.transformer import (apply_ffn, apply_layer,
                                            apply_mixer, ffn_kind,
                                            init_layer_params)
from .dtypes import to_host, torch_dtype
from .offload_engine import OffloadableModel, OffloadUnit


# a mixer kind by the parameter only that kind of block has
_MIXER_KEYS = (("kda.w_q", "kda"), ("attn.w_dkv", "mla"), ("attn.w_q", "attn"),
               ("ssm.w_in_x", "mamba"), ("mlstm.w_q", "mlstm"),
               ("slstm.w_x", "slstm"))


def block_kinds(params) -> tuple[str, str]:
    """A block's (mixer, ffn) kinds from its own parameters: blocks of
    one model may mix differently (KDA beside MLA) and a leading dense
    block of a MoE config has no router."""
    mixer = next(kind for key, kind in _MIXER_KEYS if key in params)
    ffn = "moe" if "moe.w_router" in params else \
        "dense" if "ffn.w_up" in params else "none"
    return mixer, ffn


def _expert_names(x: int) -> tuple[str, str, str]:
    return (f"moe.expert{x}.w_gate", f"moe.expert{x}.w_up",
            f"moe.expert{x}.w_down")


def _split_experts(cfg: ModelConfig, params: dict) -> dict:
    """One MoE block's params with the stacked ``(E, ...)`` expert tensors
    split into per-expert params (the reference's paged layout)."""
    params = dict(params)
    stacks = [params.pop(k) for k in ("moe.w_gate", "moe.w_up",
                                      "moe.w_down")]
    for x in range(cfg.moe.n_held):
        for name, stack in zip(_expert_names(x), stacks, strict=True):
            params[name] = np.ascontiguousarray(stack[x])
    return params


def _expert_meta(cfg: ModelConfig, units) -> dict | None:
    """``expert_meta`` of units that carry per-expert pages (None when
    none does): unit name -> {"n_experts": the pages' count, "experts":
    name triples, "held": the global ids [first, end) the pages are,
    page x expert first + x}."""
    paged = [u.name for u in units if _expert_names(0)[0] in u.params]
    if not paged:
        return None
    e = cfg.moe.n_held
    return {name: {"n_experts": e,
                   "experts": [_expert_names(x) for x in range(e)],
                   "held": cfg.moe.held_range}
            for name in paged}


def make_offloadable_lm(cfg: ModelConfig, generator_or_seed,
                        compute_dtype=torch.bfloat16, *,
                        device="cuda",
                        expert_paging: str = "off",
                        host_dtype: str = "float32") -> OffloadableModel:
    """Fresh units drawn from ``generator_or_seed`` (a
    ``torch.Generator``, or an int seeding a CPU generator), with the
    applies running in ``compute_dtype`` on ``device``.  With
    ``expert_paging`` "all" or "routed" each MoE block's expert stacks
    are split into per-expert pages (the policy's ``expert_paging`` must
    then name the same residency family).  ``host_dtype="float32"`` keeps
    the units as fp32 masters (training and serving);
    ``"bfloat16"`` rounds each drawn tensor to bf16 bits on its way to
    the host, half the host memory, for serving only (a train session
    refuses them)."""
    if expert_paging not in ("off", "all", "routed"):
        raise ValueError(f"expert_paging must be 'off'|'all'|'routed', got "
                         f"{expert_paging!r}")
    ffns = {ffn_kind(cfg, i) for i in range(cfg.n_layers)}
    if expert_paging != "off" and "moe" not in ffns:
        raise ValueError(f"{cfg.name}: expert_paging={expert_paging!r} "
                         f"needs a MoE config (ffn kinds {sorted(ffns)})")
    dev = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = torch.Generator().manual_seed(int(generator_or_seed))

    if host_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"host_dtype must be 'float32'|'bfloat16', got "
                         f"{host_dtype!r}")

    def host(t: torch.Tensor) -> np.ndarray:
        return to_host(t.to(torch_dtype(host_dtype)))

    units = [OffloadUnit("embed", "standalone", {
        "embed": host(trunc_normal(gen, (cfg.vocab, cfg.d_model), 0.02))})]
    for i in range(cfg.n_layers):
        params = init_layer_params(gen, cfg, i, place=host)
        if expert_paging != "off" and ffn_kind(cfg, i) == "moe":
            params = _split_experts(cfg, params)
        units.append(OffloadUnit(f"block_{i:03d}", "block", params))
    head_params = {"final_norm": host(torch.zeros(cfg.d_model))}
    # tied embeddings share the table; an untied head projects its own
    head_params["head"] = (
        _transposed(units[0].params["embed"]) if cfg.tie_embeddings
        else host(fan_in_init(gen, (cfg.d_model, cfg.vocab))))
    units.append(OffloadUnit("head", "standalone", head_params))
    return from_numpy_units(cfg, units, compute_dtype, device=dev)


def _transposed(table: np.ndarray) -> np.ndarray:
    """A contiguous copy of the 2-D host ``table``'s transpose, bits as
    they are, through torch's threaded copy (numpy's strided transpose
    copy is several times slower on an embedding-sized table)."""
    ints = {2: np.int16, 4: np.int32}[table.dtype.itemsize]
    return torch.from_numpy(table.view(ints)).T.contiguous().numpy() \
        .view(table.dtype)


def from_numpy_units(cfg: ModelConfig, units, compute_dtype=torch.bfloat16,
                     *, device="cuda") -> OffloadableModel:
    """An OffloadableModel over existing units (any objects with ``.name``,
    ``.kind`` and ``.params`` of numpy arrays), applies on ``device``.
    Units holding per-expert pages get the expert-paged applies."""
    dev = resolve_device(device)
    own = [OffloadUnit(u.name, u.kind,
                       {k: np.asarray(v) for k, v in u.params.items()})
           for u in units]
    expert_meta = _expert_meta(cfg, own)
    mixers = sorted({block_kinds(u.params)[0] for u in own
                     if u.kind == "block"})

    def embed_apply(params, tokens):
        return embed_lookup(params["embed"].to(compute_dtype), tokens,
                            scale=cfg.embed_scale)

    def block_apply(params, h):
        return apply_layer(cfg, block_kinds(params), params, h)[0]

    def ffn(params, h):
        return apply_ffn(cfg, block_kinds(params)[1], params, h)[0]

    def head_logits(params, h):
        h = rms_norm(h, params["final_norm"].to(compute_dtype), cfg.rms_eps)
        return lm_logits(h, params["head"].to(compute_dtype))

    def head_loss(params, h, labels):
        return cross_entropy(head_logits(params, h), labels)

    def block_prefill(params, h):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k, v = gqa_prefill(params, hn, cfg)
        return ffn(params, h + mix), k, v

    def block_step(params, h, k_cache, v_cache, cache_len, *, chunk=None):
        # ``chunk`` keeps the attention reductions extent-invariant — see
        # gqa_step; the session passes its decode time-bucket size
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        mix, k_new, v_new = gqa_step(params, hn, cfg, k_cache, v_cache,
                                     cache_len, chunk=chunk)
        return ffn(params, h + mix), k_new, v_new

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
        out = [ffn(params, c + m)
               for c, m in zip(cols, split_positions(mix), strict=True)]
        return torch.cat(out, dim=1), k_new, v_new

    def kv_shape(batch: int, time: int) -> tuple:
        return (2, batch, time, cfg.n_kv_heads, cfg.head_dim)

    applies = dict(block_prefill=block_prefill, block_step=block_step,
                   block_verify=block_verify, kv_shape=kv_shape)
    if expert_meta is not None:
        applies.update(_paged_applies(cfg))
        applies["expert_capacity"] = lambda t: _capacity(cfg, t)
    if mixers != ["attn"]:
        # cached decode takes attention mixers only, as in the reference
        # (the MLA latent and the recurrent states are the resident
        # model's caches): keep the applies of the train and uncached
        # paths, and refuse a DecodeSpec session where it asks the pages'
        # shape, naming the mixers
        def refuse(*args, **kwargs):
            raise ValueError(
                "no cached-decode applies for blocks of "
                f"{', '.join(m.upper() for m in mixers)}: decode="
                "DecodeSpec(...) needs attention mixers only (train and "
                "uncached decode run these blocks)")

        applies = {k: v for k, v in applies.items()
                   if k in ("block_route", "block_moe", "block_moe_bwd",
                            "expert_capacity")}
        applies.update(block_prefill=refuse, block_step=refuse,
                       block_verify=refuse, kv_shape=refuse)
    return OffloadableModel(units=own, embed_apply=embed_apply,
                            class_of=ModelConfig.class_of_param, device=dev,
                            block_apply=block_apply, head_loss=head_loss,
                            head_logits=head_logits, expert_meta=expert_meta,
                            **applies)


def _paged_applies(cfg: ModelConfig) -> dict:
    """The expert-paged applies of a MoE block: a routing half (the mixer
    and the router's top-k, whose indices the host reads back to decide
    which expert pages to fetch) and an expert half (the routed FFN over
    staged (E, ...) stacks whose unrouted rows are zero and never read by
    moe_ffn's dispatch or combine, so routed and all-resident residency
    give the same bits).  The backward recomputes the whole block under
    autograd with the forward's expert indices pinned."""

    def route_idx(params, hmid):
        # the logits and the router moe_ffn recomputes; only the top-k
        # indices go on to the host's fetch decision
        hn = rms_norm(hmid, params["norm_ffn"], cfg.rms_eps)
        b, s, d = hn.shape
        logits = router_logits(hn.reshape(b * s, d), params, cfg)
        return route_top_k(logits, params, cfg)[1]

    def mixer_half(params, h):
        hn = rms_norm(h, params["norm_mixer"], cfg.rms_eps)
        return h + apply_mixer(cfg, block_kinds(params)[0], params, hn)

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
            # the sigmoid gate's selection bias only picks: a zero grad
            grads = torch.autograd.grad(
                out, [p[k] for k in keys] + stacks + [x], grad_outputs=dh,
                allow_unused=True, materialize_grads=True)
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
