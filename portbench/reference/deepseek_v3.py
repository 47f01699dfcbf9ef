"""Plain float32 DeepSeek-V3-style decoder (Moonlight-16B-A3B) in PyTorch:
the yardstick the port is held to in the MLA and sigmoid-gate cells.

Written from the published architecture (``DeepseekV3`` of the model's
config.json, ``model_type: deepseek_v3``): pre-norm blocks of multi-head
latent attention and a SwiGLU FFN, the first ``first_k_dense_replace``
layers dense and every later one a mixture of experts, a final RMS norm,
an untied head, the mean token cross entropy, and AdamW with bias
correction.

* MLA: queries through one ``w_q`` (d, H x (nope + rope)) where
  ``q_lora_rank`` is null, or through the latent ``w_dq`` -> RMS norm ->
  ``w_uq``; keys and values from the latent ``w_dkv`` (d, kv_lora_rank +
  rope), whose rope part is one key head shared by every query head and
  whose latent part goes through an RMS norm and ``w_ukv`` (kv_lora_rank,
  H x (nope + v)); causal softmax over ``q . k / sqrt(nope + rope)``.
* The gate (``scoring_func: sigmoid``, ``topk_method: noaux_tc`` with
  ``n_group = topk_group = 1``): fp32 logits, scores ``sigmoid(logits)``,
  the experts chosen by the top-k of ``scores + bias``, the weights the
  unbiased scores at the chosen experts over their sum (+ 1e-20) times
  ``routed_scaling_factor``.  The bias only picks: it has no gradient and
  stays fixed in training, as in a fine-tune.
* ``n_shared_experts`` always-on experts as one SwiGLU of their summed
  width, added to the routed experts' output.

Departures, each stated in the configuration's ``assumed``: rope rotates
the rope part's halves (i, i + 32), where the release first interleaves
them (a fixed permutation of the 64 rope columns of ``w_q`` and
``w_dkv``, the same function on random weights); RMSNorm scales by ``1 +
w`` (its weights are drawn as 0); each expert keeps the first
``int(max(k*T // E * factor, minimum))`` (token, choice) pairs in
token-major order (choices in descending order of ``scores + bias``)
and drops the rest, where the source is dropless; no auxiliary loss.

Every tensor is float32 and TF32 is off while the reference runs
(:func:`exact_fp32`).  ``fp8=True`` computes every matrix product from
float8 operands (:mod:`reference.qwen3`'s), the control one precision
below the port's bf16.

Imports torch and nothing of the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import qwen3
from reference.qwen3 import exact_fp32  # noqa: F401  (this module's API)


def is_moe_layer(cfg: dict, i: int) -> bool:
    """Layer ``i`` is a mixture of experts (after the leading dense ones,
    every ``moe_layer_freq``-th)."""
    return i >= cfg["first_k_dense_replace"] and \
        i % cfg["moe_layer_freq"] == 0


class Model(qwen3.Model):
    """One configuration's functions over a tree of float32 tensors
    (``{"embed", "layers.{i}.<name>", "final_norm", "head"}``; expert
    tensors stacked along a leading expert axis)."""

    def __init__(self, cfg: dict, *, fp8: bool = False):
        self.cfg = cfg
        self.fp8 = fp8
        self.eps = cfg["rms_norm_eps"]
        rope = cfg["qk_rope_head_dim"]
        self.inv_freq = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, rope, 2, dtype=torch.float64) / rope))

    def attention(self, p, pre, x):
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg["num_attention_heads"]
        nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                          cfg["v_head_dim"])
        rank = cfg["kv_lora_rank"]
        if cfg["q_lora_rank"] is None:
            q = self.linear(x, p[pre + "attn.w_q"])
        else:
            q = self.linear(self.rms_norm(
                self.linear(x, p[pre + "attn.w_dq"]),
                p[pre + "attn.q_lat_norm"]), p[pre + "attn.w_uq"])
        q = q.view(b, s, h, nope + rope)
        latent = self.linear(x, p[pre + "attn.w_dkv"])
        c_kv, k_rope = latent.split([rank, rope], dim=-1)
        kv = self.linear(self.rms_norm(c_kv, p[pre + "attn.kv_lat_norm"]),
                         p[pre + "attn.w_ukv"]).view(b, s, h, nope + dv)
        k_nope, v = kv.split([nope, dv], dim=-1)
        pos = torch.arange(s, device=x.device)
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        q = torch.cat([q_nope, self.rope(q_rope, pos)], dim=-1)
        k_rope = self.rope(k_rope[:, :, None, :], pos).expand(b, s, h, rope)
        k = torch.cat([k_nope, k_rope], dim=-1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, .)
        scores = self.matmul(q, k.transpose(-1, -2)) / math.sqrt(nope + rope)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = self.matmul(torch.softmax(scores, dim=-1), v)
        out = out.transpose(1, 2).reshape(b, s, h * dv)
        return self.linear(out, p[pre + "attn.w_o"])

    def gate(self, p, pre, xf):
        """(choices (T, k) int64 in descending order of score + bias, their
        weights (T, k))."""
        cfg = self.cfg
        scores = torch.sigmoid(self.linear(xf, p[pre + "moe.w_router"]))
        biased = scores + p[pre + "moe.router_bias"].detach()
        _, top_i = torch.sort(biased, dim=-1, descending=True, stable=True)
        top_i = top_i[:, :cfg["num_experts_per_tok"]]
        w = scores.gather(-1, top_i)
        if cfg["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return top_i, w * cfg["routed_scaling_factor"]

    def experts(self, p, pre, x):
        """The gate, a capacity of first-come (token, choice) pairs an
        expert, each expert's SwiGLU over the tokens it kept, and the
        shared experts over every token."""
        cfg = self.cfg
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        t, e, k = b * s, cfg["n_routed_experts"], cfg["num_experts_per_tok"]
        top_i, top_w = self.gate(p, pre, xf)
        capacity = int(max(k * t // e * cfg["moe_capacity_factor"],
                           cfg["moe_capacity_min"]))
        choice = top_i.reshape(-1)                        # token-major
        onehot = F.one_hot(choice, e)
        rank = (onehot.cumsum(0) - onehot)[
            torch.arange(t * k, device=choice.device), choice]
        kept = rank < capacity
        weight = top_w.reshape(-1)
        out = self.mlp(xf, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                       p[pre + "shared.w_down"])
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
        if is_moe_layer(self.cfg, i):
            return x + self.experts(p, pre, hn)
        return x + self.mlp(hn, p[pre + "ffn.w_gate"], p[pre + "ffn.w_up"],
                            p[pre + "ffn.w_down"])

    def routing(self, p, x_in, i):
        """Layer ``i``'s choices (T, k) for the block input ``x_in``: what
        the gate picks before the capacity drops."""
        pre = f"layers.{i}."
        x = x_in + self.attention(p, pre,
                                  self.rms_norm(x_in, p[pre + "norm_mixer"]))
        hn = self.rms_norm(x, p[pre + "norm_ffn"])
        return self.gate(p, pre, hn.reshape(-1, hn.shape[-1]))[0]

    def block_inputs(self, p, tokens):
        """Every block's input, in order (for :meth:`routing`)."""
        x = p["embed"][tokens]
        out = []
        for i in range(self.cfg["num_hidden_layers"]):
            out.append(x)
            x = self.block(p, i, x)
        return out


def frozen(cfg: dict) -> list[str]:
    """The tensors that only pick (the gates' selection biases): no
    gradient, never trained."""
    return [f"layers.{i}.moe.router_bias"
            for i in range(cfg["num_hidden_layers"]) if is_moe_layer(cfg, i)]


def train(model: Model, params: dict, batches, *, lr: float,
          weight_decay: float = 0.0, on_first_grads=None,
          state_device=None) -> list[float]:
    """Adam steps over ``batches`` [(tokens, labels) device tensors],
    training ``params`` in place (the biases of :func:`frozen` stay as
    they are).  Returns each step's loss.  ``on_first_grads`` is called
    with the first step's gradients (every tensor of ``params``, a frozen
    one's zero) before they are dropped; ``state_device`` keeps Adam's
    m and v there (the host, where the device has no room), each tensor's
    moved to the parameter's device for its update."""
    fixed = set(frozen(model.cfg))
    leaves = {n: t.requires_grad_() for n, t in params.items()
              if n not in fixed}
    state: dict = {}
    losses = []
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss = model.loss(params, tokens, labels)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values())), strict=True))
        losses.append(float(loss.detach()))
        del loss
        if step == 1 and on_first_grads is not None:
            on_first_grads({n: grads[n] if n in grads else
                            torch.zeros_like(t) for n, t in params.items()})
        for name in list(grads):
            p = leaves[name]
            where = state_device or p.device
            m, v = state.setdefault(name, (
                torch.zeros(p.shape, device=where),
                torch.zeros(p.shape, device=where)))
            dev = {name: (m.to(p.device), v.to(p.device))}
            qwen3.adamw_({name: p}, {name: grads.pop(name)}, dev, step,
                         lr=lr, weight_decay=weight_decay)
            if state_device is not None:
                m.copy_(dev[name][0])
                v.copy_(dev[name][1])
    for t in leaves.values():
        t.requires_grad_(False)
    return losses
