"""Plain float32 Qwen3 in PyTorch: the yardstick the port is held to.

Written from the published architecture (Qwen3's config.json and the
``Qwen3`` / ``Qwen3Moe`` decoder layer): a pre-norm block of grouped-query
attention with per-head RMS norms on q and k before rotary embeddings
(rotate-half, ``rope_theta``), causal softmax attention, and a SwiGLU MLP
or a top-k mixture of SwiGLU experts with the chosen probabilities
renormalised; a final RMS norm and an untied head; the mean token cross
entropy; and AdamW with bias correction.

Departures, each stated in the configuration's ``assumed``: RMSNorm
scales by ``1 + w`` (its weights are drawn as 0); the expert layer keeps
the first ``int(max(k*T // E * factor, minimum))`` (token, choice) pairs
of each expert in token-major order and drops the rest.

Every tensor is float32 and TF32 is switched off while the reference
runs.  ``fp8=True`` computes every matrix product from operands rounded
to float8 (e4m3 forward, e5m2 for the gradients of the backward, one
scale a tensor): the control, one precision below the port's bf16.

Imports torch and nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the block (a float32 product may otherwise run in
    TF32 on the card)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``, back in x's dtype."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _fp8(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Model:
    """One configuration's functions over a tree of float32 tensors
    (``{"embed", "layers.{i}.<name>", "final_norm", "head"}``)."""

    def __init__(self, cfg: dict, *, fp8: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.eps = cfg["rms_norm_eps"]
        hd = cfg["head_dim"]
        self.inv_freq = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64) / hd))

    # -- pieces --------------------------------------------------------------

    def matmul(self, a, b):
        """``a @ b`` over the last two axes (equal leading axes)."""
        if self.fp8:
            return _Fp8MatMul.apply(a, b)
        return a @ b

    def linear(self, x, w):
        """x (..., d_in) times w (d_in, d_out)."""
        return self.matmul(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[-1])

    def rms_norm(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * (1.0 + w)

    def rope(self, x, positions):
        """x (B, S, H, hd); rotate-half pairs (i, i + hd/2)."""
        angles = positions[:, None].double() * self.inv_freq.to(x.device)
        cos = torch.cos(angles).float()[None, :, None, :]
        sin = torch.sin(angles).float()[None, :, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, p, pre, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                     cfg["head_dim"])
        q = self.linear(x, p[pre + "attn.w_q"]).view(b, s, h, hd)
        k = self.linear(x, p[pre + "attn.w_k"]).view(b, s, kh, hd)
        v = self.linear(x, p[pre + "attn.w_v"]).view(b, s, kh, hd)
        q = self.rms_norm(q, p[pre + "attn.q_norm"])
        k = self.rms_norm(k, p[pre + "attn.k_norm"])
        pos = torch.arange(s, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        group = h // kh            # query head j reads key/value head j // group
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
        scores = self.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = self.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, s, h * hd)
        return self.linear(out, p[pre + "attn.w_o"])

    def mlp(self, x, w_gate, w_up, w_down):
        return self.linear(F.silu(self.linear(x, w_gate))
                           * self.linear(x, w_up), w_down)

    def experts(self, p, pre, x):
        """Top-k routing over softmax probabilities, the chosen k
        renormalised, a capacity of first-come (token, choice) pairs an
        expert, each expert's SwiGLU over the tokens it kept."""
        cfg = self.cfg
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        t, e, k = b * s, cfg["num_experts"], cfg["num_experts_per_tok"]
        probs = torch.softmax(self.linear(xf, p[pre + "moe.w_router"]), -1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_i = top_p[:, :k], top_i[:, :k]
        if cfg["norm_topk_prob"]:
            top_p = top_p / top_p.sum(-1, keepdim=True)
        capacity = int(max(k * t // e * cfg["moe_capacity_factor"],
                           cfg["moe_capacity_min"]))
        choice = top_i.reshape(-1)                        # token-major
        onehot = F.one_hot(choice, e)
        rank = (onehot.cumsum(0) - onehot)[
            torch.arange(t * k, device=choice.device), choice]
        kept = rank < capacity
        weight = top_p.reshape(-1)
        out = torch.zeros_like(xf)
        gate, up, down = (p[pre + n] for n in ("moe.w_gate", "moe.w_up",
                                                "moe.w_down"))
        for x_e in range(e):
            pairs = torch.nonzero(kept & (choice == x_e)).flatten()
            if pairs.numel() == 0:
                continue
            tok = pairs // k
            y = self.mlp(xf[tok], gate[x_e], up[x_e], down[x_e])
            out = out.index_add(0, tok, y * weight[pairs, None])
        return out.view(b, s, d)

    def block(self, p, i, x):
        pre = f"layers.{i}."
        x = x + self.attention(p, pre, self.rms_norm(x, p[pre + "norm_mixer"]))
        hn = self.rms_norm(x, p[pre + "norm_ffn"])
        if self.cfg.get("num_experts"):
            return x + self.experts(p, pre, hn)
        return x + self.mlp(hn, p[pre + "ffn.w_gate"], p[pre + "ffn.w_up"],
                            p[pre + "ffn.w_down"])

    # -- whole model ---------------------------------------------------------

    def logits(self, p, tokens):
        """(B, S) int64 -> (B, S, vocab) float32."""
        x = p["embed"][tokens]
        for i in range(self.cfg["num_hidden_layers"]):
            x = self.block(p, i, x)
        return self.linear(self.rms_norm(x, p["final_norm"]), p["head"])

    def loss(self, p, tokens, labels):
        logits = self.logits(p, tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))


def adamw_(params: dict, grads: dict, state: dict, step: int, *, lr: float,
           beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
           weight_decay: float = 0.0) -> None:
    """One Adam step in place: ``p -= lr * ((m / (1 - b1^t)) /
    (sqrt(v / (1 - b2^t)) + eps) + wd * p)``."""
    bias1, bias2 = 1.0 - beta1 ** step, 1.0 - beta2 ** step
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p),
                                           torch.zeros_like(p)))
            m.mul_(beta1).add_(g, alpha=1.0 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
            update = (m / bias1) / ((v / bias2).sqrt() + eps)
            if weight_decay:
                update = update + weight_decay * p
            p.sub_(lr * update)


def train(model: Model, params: dict, batches, *, lr: float,
          weight_decay: float = 0.0) -> dict:
    """Adam steps over ``batches`` [(tokens, labels) device tensors] from
    copies of ``params``.  Returns each step's loss, the first step's
    gradients, and the parameters after the last step."""
    leaves = {n: t.detach().clone().requires_grad_()
              for n, t in params.items()}
    state: dict = {}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss = model.loss(leaves, tokens, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads, strict=True))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        adamw_(leaves, grads, state, step, lr=lr, weight_decay=weight_decay)
        del loss
    del state
    return {"losses": losses, "grads": first,
            "params": {n: t.detach() for n, t in leaves.items()}}
