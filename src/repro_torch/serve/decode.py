"""The device-resident decode (serving) step and its speculative verify.

Port of ``src/repro/serve/decode.py`` for one card (no mesh, so no
shardings): ``serve_step(params, cache, tokens, cache_len) -> (logits,
new_cache)`` is one new token against the resident model's KV / latent
cache.  The cache comes back as new tensors; the one passed in is left as
it was.

``build_verify_step`` is the speculative-decoding counterpart: a K-wide
token window folded through the same single-token step, as the
reference's ``lax.scan`` folds it, returning every position's logits.
Running the exact step function keeps the logits chain bitwise the
step chain's.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape
from repro_torch.models.registry import ModelImpl


def build_serve_step(impl: ModelImpl, shape: InputShape, *,
                     cache_dtype=torch.bfloat16):
    """Returns ``(serve_fn, arg_specs)``; ``arg_specs`` is
    ``(cache_specs, tokens_spec, cache_len_spec)``."""
    arg_specs = impl.decode_args_specs(shape, cache_dtype)

    def serve(params, cache, tokens, cache_len):
        with torch.no_grad():
            return impl.decode_fn(params, cache, tokens, cache_len)

    return serve, arg_specs


def build_verify_step(impl: ModelImpl, shape: InputShape, *, window: int,
                      cache_dtype=torch.bfloat16):
    """Returns ``(verify_fn, arg_specs)``.

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
    return verify, (cache_specs, window_spec, len_spec)
