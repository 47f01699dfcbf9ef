"""Plain float32 Kimi Linear (Kimi-Linear-48B-A3B) in PyTorch: the
yardstick the port is held to in the KDA cell.

Written from the published architecture (``model_type: kimi_linear`` of
the model's config.json, and the Kimi Linear report, arXiv:2510.26692):
pre-norm blocks whose mixer is Kimi Delta Attention (KDA) in the layers
``linear_attn_config.kda_layers`` names and MLA in those
``full_attn_layers`` names (both 1-based), the first
``first_k_dense_replace`` layers with a dense SwiGLU FFN and every later
one a mixture of experts, a final RMS norm, an untied head, the mean
token cross entropy, and AdamW with bias correction.

* KDA, H heads of d channels (``linear_attn_config``): q, k, v the SiLU
  of a causal depthwise conv (``short_conv_kernel_size`` taps, no bias)
  of their projections, q and k L2-normalised per head; the per-channel
  log-decay g_t = -exp(A_log) softplus(w_fb w_fa x_t + dt_bias), beta_t =
  sigmoid(w_b x_t) a head; the token recurrence
  S_t = (I - beta_t k_t k_t^T) Diag(exp g_t) S_{t-1} + beta_t k_t v_t^T
  from S_0 = 0, o_t = d^-1/2 S_t^T q_t, one step a token (not a chunked
  form); its gradient is the chain rule written out over the same token
  steps (:class:`DeltaRule`), recomputed a segment of :data:`SEGMENT`
  tokens at a time so that a long sequence's backward fits; then RMSNorm
  over each head's d channels, times sigmoid(w_gb w_ga x_t + b_gb),
  through w_o.
* MLA as :mod:`reference.deepseek_v3` computes it, with no rope where
  ``mla_use_nope`` holds: the 64 rope columns of q and of the shared key
  head enter the scores unrotated.
* The gate (``moe_router_activation_func: sigmoid``, one group): scores
  ``sigmoid(logits)`` over all ``router_experts``, the experts chosen by
  the top-k of ``scores + bias``, the weights the unbiased scores at the
  chosen experts over their sum (+ 1e-20) times
  ``routed_scaling_factor``.  The bias only picks and stays fixed.
* The chip's share (``held_experts`` [first, end) of the
  ``router_experts`` the gate picks from; ``num_experts`` of them): each
  held expert keeps its first ``int(max(k*T // router_experts * factor,
  minimum))`` (token, choice) pairs in token-major order and computes
  them; pairs routed to other experts are another chip's and add
  nothing here.  ``num_shared_experts`` always-on experts as one SwiGLU
  of their summed width, added to the routed part.

Departures, each stated in the configuration's ``assumed``: RMSNorm
scales by ``1 + w`` (its weights are drawn as 0); the capacity drop
(the source is dropless); no auxiliary loss.

Every tensor is float32 and TF32 is off while the reference runs
(:func:`exact_fp32`).  ``fp8=True`` computes every projection from
float8 operands (:mod:`reference.qwen3`'s), the control one precision
below the port's bf16; KDA's recurrence stays fp32, as the port's does.

Imports torch and nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import deepseek_v3
from reference.deepseek_v3 import frozen, is_moe_layer, train  # noqa: F401
from reference.qwen3 import exact_fp32  # noqa: F401  (this module's API)

SEGMENT = 256     # tokens of the recurrence between checkpoints
L2_EPS = 1e-6


def is_kda_layer(cfg: dict, i: int) -> bool:
    """Layer ``i`` (0-based) mixes by KDA."""
    return i + 1 in cfg["linear_attn_config"]["kda_layers"]


def recurrence(q, k, v, g, beta, state=None):
    """The delta rule one token at a time: q, k, g (B, L, H, d_k), v (B,
    L, H, d_v), beta (B, L, H), ``state`` (B, H, d_k, d_v) or zero.
    Returns (o (B, L, H, d_v), the last state)."""
    b, n, h, dk = k.shape
    if state is None:
        state = k.new_zeros((b, h, dk, v.shape[-1]))
    scale = dk ** -0.5
    outs = []
    for t in range(n):
        state = state * torch.exp(g[:, t])[..., None]
        kt = k[:, t]
        read = torch.einsum("bhc,bhcv->bhv", kt, state)
        state = state + beta[:, t, :, None, None] * kt[..., None] * \
            (v[:, t] - read)[..., None, :]
        outs.append(torch.einsum("bhcv,bhc->bhv", state, q[:, t]) * scale)
    return torch.stack(outs, dim=1), state


def _token_major(t, *trail):
    """(B, L, H, ...) as (L, B*H, *trail)."""
    b, n, h = t.shape[:3]
    return t.transpose(0, 1).reshape((n, b * h) + trail)


def _states(s0, a, k, bk, v):
    """The recurrence's states over one segment, from ``s0`` (N, d_k,
    d_v): a, k, bk (L, N, d_k, 1) the decays, keys and beta * keys, v (L,
    N, 1, d_v).  Returns the states (L + 1, N, d_k, d_v), s0 first, and
    each token's correction v_t - k_t^T Diag(a_t) S_{t-1} (L, N, 1,
    d_v)."""
    states = s0.new_empty((a.shape[0] + 1,) + s0.shape)
    states[0] = s0
    w = v.new_empty(v.shape)
    for t in range(a.shape[0]):
        decayed = states[t] * a[t]
        torch.sub(v[t], k[t].mT @ decayed, out=w[t])
        torch.baddbmm(decayed, bk[t], w[t], out=states[t + 1])
    return states, w


class DeltaRule(torch.autograd.Function):
    """:func:`recurrence` from a zero state over a whole sequence, with
    its gradient written out over the same token steps: the forward keeps
    the state at every :data:`SEGMENT`-th token; the backward recomputes
    a segment's states from there and takes the chain rule back through
    its tokens, last to first (eager autograd would record some ten nodes
    a token)."""

    @staticmethod
    def forward(ctx, q, k, v, g, beta):
        b, n, h, dk = k.shape
        dv = v.shape[-1]
        a, kc, vc = (_token_major(torch.exp(g), dk, 1),
                     _token_major(k, dk, 1), _token_major(v, 1, dv))
        bk = _token_major(beta[..., None] * k, dk, 1)
        qc = _token_major(q, 1, dk)
        state = k.new_zeros((b * h, dk, dv))
        starts, out = [], v.new_empty((n, b * h, 1, dv))
        for lo in range(0, n, SEGMENT):
            hi = min(lo + SEGMENT, n)
            starts.append(state)
            states, _ = _states(state, a[lo:hi], kc[lo:hi], bk[lo:hi],
                                vc[lo:hi])
            torch.matmul(qc[lo:hi], states[1:], out=out[lo:hi])
            state = states[-1].clone()
            del states
        ctx.save_for_backward(q, k, v, g, beta, *starts)
        return (out * dk ** -0.5).view(n, b, h, dv).transpose(0, 1)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, g, beta, *starts = ctx.saved_tensors
        b, n, h, dk = k.shape
        dv = v.shape[-1]
        a, kc, vc = (_token_major(torch.exp(g), dk, 1),
                     _token_major(k, dk, 1), _token_major(v, 1, dv))
        bk = _token_major(beta[..., None] * k, dk, 1)
        qc = _token_major(q, dk, 1)
        do = _token_major(d_out * dk ** -0.5, 1, dv)
        # per token: dq, d(beta k), d(w), the keys' part through the read,
        # and d(a)
        dq, dbk, dw, dk_read, da = (
            k.new_empty((n, b * h, dk, 1)), k.new_empty((n, b * h, dk, 1)),
            v.new_empty((n, b * h, 1, dv)), k.new_empty((n, b * h, dk, 1)),
            k.new_empty((n, b * h, dk, 1)))
        d_state = k.new_zeros((b * h, dk, dv))
        for i in reversed(range(len(starts))):
            lo, hi = i * SEGMENT, min((i + 1) * SEGMENT, n)
            states, w = _states(starts[i], a[lo:hi], kc[lo:hi], bk[lo:hi],
                                vc[lo:hi])
            torch.matmul(states[1:], do[lo:hi].mT, out=dq[lo:hi])
            d_decayed = torch.empty_like(states[1:])
            for t in reversed(range(hi - lo)):
                grad = torch.baddbmm(d_state, qc[lo + t], do[lo + t])
                torch.bmm(grad, w[t].mT, out=dbk[lo + t])
                torch.bmm(bk[lo + t].mT, grad, out=dw[lo + t])
                torch.baddbmm(grad, kc[lo + t], dw[lo + t], alpha=-1,
                              out=d_decayed[t])
                d_state = d_decayed[t] * a[lo + t]
            before = states[:-1]
            torch.sum(d_decayed * before, -1, keepdim=True, out=da[lo:hi])
            torch.matmul(before, dw[lo:hi].mT, out=dk_read[lo:hi])
            dk_read[lo:hi] *= -a[lo:hi]
            del states, w, d_decayed, before

        def back(t, *trail):
            return t.view((n, b, h) + trail).transpose(0, 1)

        dbk = back(dbk, dk)
        return (back(dq, dk), back(dk_read, dk) + beta[..., None] * dbk,
                back(dw, dv), back(da * a, dk), (k * dbk).sum(-1))


def delta_rule(q, k, v, g, beta):
    """The recurrence's outputs (B, L, H, d_v) from a zero state."""
    return DeltaRule.apply(q, k, v, g, beta)


class Model(deepseek_v3.Model):
    """One configuration's functions over a tree of float32 tensors
    (``{"embed", "layers.{i}.<name>", "final_norm", "head"}``; the held
    experts' tensors stacked along a leading expert axis)."""

    def rope(self, x, positions):
        if self.cfg["mla_use_nope"]:
            return x
        return super().rope(x, positions)

    def short_conv(self, x, w):
        taps = w.shape[0]
        xp = F.pad(x, (0, 0, taps - 1, 0))
        s = x.shape[1]
        return F.silu(sum(w[i] * xp[:, i:i + s] for i in range(taps)))

    def kda(self, p, pre, x):
        lin = self.cfg["linear_attn_config"]
        b, s, _ = x.shape
        h, d = lin["num_heads"], lin["head_dim"]

        def heads(t):
            return t.reshape(b, s, h, d)

        q, k, v = (heads(self.short_conv(
            self.linear(x, p[pre + f"kda.w_{n}"]), p[pre + f"kda.conv_{n}"]))
            for n in "qkv")
        q, k = (t * torch.rsqrt(t.square().sum(-1, keepdim=True) + L2_EPS)
                for t in (q, k))
        decay_in = self.linear(self.linear(x, p[pre + "kda.w_fa"]),
                               p[pre + "kda.w_fb"]) + p[pre + "kda.dt_bias"]
        g = -torch.exp(p[pre + "kda.a_log"])[:, None] * \
            F.softplus(heads(decay_in))
        beta = torch.sigmoid(self.linear(x, p[pre + "kda.w_b"]))
        o = self.rms_norm(delta_rule(q, k, v, g, beta),
                          p[pre + "kda.o_norm"])
        gate = self.linear(self.linear(x, p[pre + "kda.w_ga"]),
                           p[pre + "kda.w_gb"]) + p[pre + "kda.b_gb"]
        o = o * torch.sigmoid(heads(gate))
        return self.linear(o.reshape(b, s, h * d), p[pre + "kda.w_o"])

    def gate(self, p, pre, xf):
        """(choices (T, k) int64 over every router expert, in descending
        order of score + bias, their weights (T, k))."""
        cfg = self.cfg
        scores = torch.sigmoid(self.linear(xf, p[pre + "moe.w_router"]))
        biased = scores + p[pre + "moe.router_bias"].detach()
        _, top_i = torch.sort(biased, dim=-1, descending=True, stable=True)
        top_i = top_i[:, :cfg["num_experts_per_token"]]
        w = scores.gather(-1, top_i)
        if cfg["moe_renormalize"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return top_i, w * cfg["routed_scaling_factor"]

    def experts(self, p, pre, x):
        """The gate over every router expert, a capacity of first-come
        (token, choice) pairs an expert, the held experts' SwiGLUs over
        the tokens they kept, and the shared experts over every token."""
        cfg = self.cfg
        b, s, d = x.shape
        xf = x.reshape(b * s, d)
        t, e = b * s, cfg["router_experts"]
        k = cfg["num_experts_per_token"]
        first, end = cfg["held_experts"]
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
        for x_e in range(first, end):
            pairs = torch.nonzero(kept & (choice == x_e)).flatten()
            if pairs.numel() == 0:
                continue
            tok = pairs // k
            y = self.mlp(xf[tok], gate[x_e - first], up[x_e - first],
                         down[x_e - first])
            out = out.index_add(0, tok, y * weight[pairs, None])
        return out.view(b, s, d)

    def block(self, p, i, x):
        pre = f"layers.{i}."
        hn = self.rms_norm(x, p[pre + "norm_mixer"])
        x = x + (self.kda(p, pre, hn) if is_kda_layer(self.cfg, i)
                 else self.attention(p, pre, hn))
        hn = self.rms_norm(x, p[pre + "norm_ffn"])
        if is_moe_layer(self.cfg, i):
            return x + self.experts(p, pre, hn)
        return x + self.mlp(hn, p[pre + "ffn.w_gate"], p[pre + "ffn.w_up"],
                            p[pre + "ffn.w_down"])

    def routing(self, p, x_in, i):
        """Layer ``i``'s choices (T, k) for the block input ``x_in``: what
        the gate picks before the capacity drops."""
        pre = f"layers.{i}."
        hn = self.rms_norm(x_in, p[pre + "norm_mixer"])
        x = x_in + (self.kda(p, pre, hn) if is_kda_layer(self.cfg, i)
                    else self.attention(p, pre, hn))
        hn = self.rms_norm(x, p[pre + "norm_ffn"])
        return self.gate(p, pre, hn.reshape(-1, hn.shape[-1]))[0]
