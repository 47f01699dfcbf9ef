"""Serve a small model with batched decode requests through the PyTorch
port's registry serve path (KV cache / recurrent state), on any
architecture family.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--arch qwen3-4b]
          [--device cuda|cpu]
      (uses the REDUCED variant of the chosen arch; on the card by
      default)
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import InputShape
from repro_torch.models import build
from repro_torch.serve import build_serve_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs an NVIDIA GPU; pass --device cpu")

    cfg = ARCHS[args.arch].reduced()
    print(f"arch {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}, family={cfg.family})")
    impl = build(cfg, device=args.device)
    params = impl.init_params(0)

    b = args.batch
    total = args.prompt_len + args.new_tokens
    cache = impl.init_cache(b, total)
    step, _specs = build_serve_step(impl, InputShape("serve", total, b,
                                                     "decode"))

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        3, cfg.vocab, size=(b, args.prompt_len), dtype=np.int32)).to(
        args.device)
    # feed the prompt token by token (prefill-by-decode keeps the example
    # uniform across KV-cache and recurrent-state families)
    for t in range(args.prompt_len):
        logits, cache = step(params, cache, prompts[:, t:t + 1], t)

    out_tokens = []
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    for t in range(args.prompt_len, total):
        logits, cache = step(params, cache, tok, t)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        out_tokens.append(tok[:, 0].cpu().numpy())
    dt = time.time() - t0
    gen = np.stack(out_tokens, axis=1)
    print(f"generated {gen.shape} tokens in {dt:.2f}s "
          f"({b * args.new_tokens / dt:.1f} tok/s)")
    for i in range(min(b, 2)):
        print(f"  request {i}: {gen[i][:16].tolist()} ...")
    print("serve OK")


if __name__ == "__main__":
    main()
