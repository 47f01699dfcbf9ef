"""The device-resident decode (serving) step and its speculative verify.

Port of ``src/repro/serve/decode.py``: ``serve_step(params, cache,
tokens, cache_len) -> (logits, new_cache)`` is one new token against the
resident model's KV / latent cache / recurrent state.  The cache comes
back as new tensors; the one passed in is left as it was.

``build_verify_step`` is the speculative-decoding counterpart: a K-wide
token window folded through the same single-token step, as the
reference's ``lax.scan`` folds it, returning every position's logits.
Running the exact step function keeps the logits chain bitwise the
step chain's.

Both take an optional ``mesh`` (:mod:`repro_torch.launch.mesh`).  With
one they return the reference's ``(fn, in_placements, out_placements,
arg_specs)``: params placed by
:func:`repro_torch.launch.sharding.param_specs` under ``param_mode``
(``"zero3"``, or ``"tp"``: model-axis only, replicated across data, so no
per-token weight all-gather), the cache by ``cache_specs``, the tokens
over the batch axes when the batch divides, the logits by
``logits_spec``; the step places plain inputs by them and runs on
DTensors under ``implicit_replication()``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import InputShape
from repro_torch.launch import sharding as shd
from repro_torch.models.registry import ModelImpl


def _meshed(impl: ModelImpl, mesh, shape: InputShape, fn, cache_specs,
            param_mode: str):
    """``fn`` over placed inputs, its logits and cache placed on the way
    out; returns ``(fn, in_placements, out_placements)``."""
    cfg = impl.cfg
    pplace = shd.param_placements(cfg, mesh, param_mode)
    cplace = shd.placements_tree(shd.cache_specs(cfg, cache_specs, mesh),
                                 mesh)
    tplace = shd.to_placements(shd.tokens_spec(mesh, shape.global_batch),
                               mesh)
    scalar = shd.replicated(mesh)
    lplace = shd.to_placements(shd.logits_spec(cfg, mesh,
                                               shape.global_batch), mesh)

    def run(params, cache, tokens, cache_len):
        params = shd.place(params, pplace, mesh)
        cache = shd.place(cache, cplace, mesh)
        tokens = shd.place(tokens, tplace, mesh)
        with implicit_replication():
            logits, cache = fn(params, cache, tokens, cache_len)
            cache = shd.spec_map(lambda pl, c: shd.as_placed(c, mesh, pl),
                                 cplace, cache)
            return shd.as_placed(logits, mesh, lplace), cache

    return run, (pplace, cplace, tplace, scalar), (lplace, cplace)


def build_serve_step(impl: ModelImpl, shape: InputShape, mesh=None, *,
                     param_mode: str = "zero3",
                     cache_dtype=torch.bfloat16):
    """Returns ``(serve_fn, arg_specs)``, or with a ``mesh``
    ``(serve_fn, in_placements, out_placements, arg_specs)``;
    ``arg_specs`` is ``(cache_specs, tokens_spec, cache_len_spec)``."""
    arg_specs = impl.decode_args_specs(shape, cache_dtype)

    def serve(params, cache, tokens, cache_len):
        with torch.no_grad():
            return impl.decode_fn(params, cache, tokens, cache_len)

    if mesh is None:
        return serve, arg_specs
    return (*_meshed(impl, mesh, shape, serve, arg_specs[0], param_mode),
            arg_specs)


def build_verify_step(impl: ModelImpl, shape: InputShape, mesh=None, *,
                      window: int, param_mode: str = "zero3",
                      cache_dtype=torch.bfloat16):
    """Returns ``(verify_fn, arg_specs)``, or with a ``mesh``
    ``(verify_fn, in_placements, out_placements, arg_specs)``.

    ``verify_fn(params, cache, tokens, cache_len) -> (logits, new_cache)``
    with ``tokens`` (batch, window) and ``logits`` (batch, window, vocab):
    position ``j``'s row is what the single-token serve-step chain gives
    after appending the window's first ``j`` tokens."""
    if window < 1:
        raise ValueError(f"verify window must be >= 1, got {window}")
    cache_specs, tokens_spec, len_spec = impl.decode_args_specs(shape,
                                                                cache_dtype)

    def verify(params, cache, tokens, cache_len):
        rows = []
        with torch.no_grad():
            for j in range(tokens.shape[1]):
                logits, cache = impl.decode_fn(params, cache,
                                               tokens[:, j:j + 1],
                                               cache_len + j)
                rows.append(logits[:, 0])
        return torch.stack(rows, dim=1), cache

    window_spec = type(tokens_spec)((shape.global_batch, window),
                                    tokens_spec.dtype)
    arg_specs = (cache_specs, window_spec, len_spec)
    if mesh is None:
        return verify, arg_specs
    return (*_meshed(impl, mesh, shape, verify, cache_specs, param_mode),
            arg_specs)
