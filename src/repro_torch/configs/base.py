"""Config schema: architectures, input shapes, and the pool census.

Every assigned architecture is a :class:`ModelConfig`; the four assigned
input shapes are :data:`INPUT_SHAPES`.  The config also derives the two
quantities MemAscend's host-side machinery needs:

* :meth:`ModelConfig.pool_census` — the shape-class census (embedding, FFN,
  QO/KV projections, experts, SSM params, ...) that sizes both the fixed
  (baseline) and adaptive (MemAscend) parameter buffer pools, and
* :meth:`ModelConfig.param_count` — for flat-buffer / optimizer-state /
  I/O-volume accounting at paper scale.

``reduced()`` returns the CPU-smoke variant (≤2 layers, d_model ≤ 512,
≤4 experts) of the same family, exercised by per-arch smoke tests; the full
configs are touched only by the ShapeDtypeStruct dry-run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "softmax": softmax-then-top-k with a load-balance loss; "sigmoid":
    # DeepSeek-V3's noaux_tc gate (fp32 logits, sigmoid scores, top-k of
    # scores + a per-expert selection bias that only picks, the unbiased
    # scores of the chosen k renormalised, no auxiliary loss)
    scoring: str = "softmax"
    routed_scale: float = 1.0    # routed weights' factor (sigmoid gate)
    # the experts this chip holds, [first, end) of the n_experts the router
    # picks from (expert parallelism's share); None: all of them.  Routing
    # and capacity run over all n_experts; only the held ones are computed
    held: tuple[int, int] | None = None

    def __post_init__(self):
        if self.scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"MoE scoring must be 'softmax'|'sigmoid', got "
                             f"{self.scoring!r}")
        if self.scoring == "softmax" and self.routed_scale != 1.0:
            raise ValueError("routed_scale belongs to the sigmoid gate")
        lo, hi = self.held_range
        if not 0 <= lo < hi <= self.n_experts:
            raise ValueError(f"held experts {self.held} outside the "
                             f"{self.n_experts} the router picks from")

    @property
    def held_range(self) -> tuple[int, int]:
        return tuple(self.held) if self.held is not None \
            else (0, self.n_experts)

    @property
    def n_held(self) -> int:
        lo, hi = self.held_range
        return hi - lo


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims [arXiv:2412.19437]."""

    kv_lora_rank: int = 512
    q_lora_rank: int | None = 1536   # None: one w_q, no query latent
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # False: the rope columns of q and the shared key head stay unrotated
    # (Kimi Linear's mla_use_nope; its KDA layers carry position)
    use_rope: bool = True


@dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention [arXiv:2510.26692] beside MLA: which layers mix
    by which, from the published 1-based lists, and the KDA mixer's shape
    (``n_heads`` heads of ``head_dim`` for q, k and v, and the width of
    the decay's and output gate's low-rank factors; a causal depthwise
    conv of ``conv_kernel`` taps)."""

    kda_layers: tuple[int, ...]
    full_attn_layers: tuple[int, ...]
    n_heads: int = 32
    head_dim: int = 128
    conv_kernel: int = 4

    @property
    def width(self) -> int:
        return self.n_heads * self.head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM block parameters."""

    kind: str = "mamba"          # "mamba" | "xlstm"
    d_state: int = 16
    expand: int = 2              # d_inner = expand * d_model
    conv_kernel: int = 4
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)
    # xLSTM only:
    slstm_every: int = 8         # one sLSTM block per this many (rest mLSTM)
    chunk: int = 128             # chunked-parallel scan chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def dt_rank_for(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention/MLP flavor
    qk_norm: bool = False
    gated_act: str = "swiglu"    # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    sliding_window: int = 0      # 0 = full attention; >0 enables SW variant
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma-style sqrt(d_model) embedding scale
    # MoE / MLA / SSM / hybrid
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    kda: KDAConfig | None = None     # KDA layers beside MLA ones
    attn_period: int = 1         # hybrid: 1 attention layer per this many
                                 # (jamba: 8 -> layers i%8==0 are attention)
    moe_period: int = 1          # MoE FFN every this many layers (jamba: 2);
                                 # other layers get a dense FFN of d_ff
    first_dense_layers: int = 0  # leading layers with a dense FFN of d_ff
                                 # ahead of the MoE period (DeepSeek's
                                 # first_k_dense_replace)
    mtp: bool = False            # DeepSeek multi-token prediction head
    # enc-dec (audio) / prefix (vlm) frontends — STUBBED per assignment
    encoder_layers: int = 0      # whisper: encoder depth
    encoder_seq: int = 0         # frames from the (stubbed) conv frontend
    prefix_len: int = 0          # vlm: image tokens from the (stubbed) ViT
    max_decode_len: int = 0      # architectural decode cap (whisper: 448)
    source: str = ""             # citation for the config

    # -- derived -----------------------------------------------------------------

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.first_dense_layers and (self.moe is None or not self.d_ff
                                        or self.first_dense_layers
                                        >= self.n_layers):
            raise ValueError(f"{self.name}: first_dense_layers needs a MoE "
                             f"config, a dense d_ff and a MoE layer after "
                             f"them")
        if self.kda is not None:
            layers = sorted(self.kda.kda_layers + self.kda.full_attn_layers)
            if layers != list(range(1, self.n_layers + 1)) or \
                    self.mla is None:
                raise ValueError(f"{self.name}: kda_layers and "
                                 f"full_attn_layers must split layers 1.."
                                 f"{self.n_layers} between them, the full "
                                 f"ones MLA")

    def is_moe_layer(self, i: int) -> bool:
        """Whether layer ``i``'s FFN is the MoE (after the leading dense
        layers, every ``moe_period``-th)."""
        return self.moe is not None and i >= self.first_dense_layers and \
            i % self.moe_period == self.moe_period - 1

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_attention_layer(self, i: int) -> bool:
        """Hybrid interleave: which layers are attention (vs SSM or KDA)."""
        if self.kda is not None:
            return i + 1 in self.kda.full_attn_layers
        if self.family != "hybrid":
            return True
        return i % self.attn_period == self.attn_period - 1

    @property
    def n_attn_layers(self) -> int:
        return sum(self.is_attention_layer(i) for i in range(self.n_layers))

    @property
    def n_ssm_layers(self) -> int:
        return self.n_layers - self.n_attn_layers if self.family == "hybrid" \
            else (self.n_layers if self.family == "ssm" else 0)

    # -- parameter census ---------------------------------------------------------

    def block_param_shapes(self, layer: int = 0) -> dict[str, tuple]:
        """Streamed-tensor shapes of one block, tagged by pool shape class.

        Returns {param_name: shape}; :meth:`class_of_param` maps names to
        shape classes.  Small per-channel vectors (norms, biases) stay
        resident in host memory (paper: tensors under ~2M elements are not
        offloaded) and are excluded.
        """
        d, shapes = self.d_model, {}
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            if s.kind == "xlstm":
                hd = d // self.n_heads
                if layer % s.slstm_every == s.slstm_every - 1:
                    shapes.update({
                        "slstm.w_x": (d, 4 * d),
                        "slstm.r": (self.n_heads, hd, 4 * hd),
                        "slstm.w_o": (d, d),
                    })
                else:
                    shapes.update({
                        "mlstm.w_q": (d, di),
                        "mlstm.w_k": (d, di),
                        "mlstm.w_v": (d, di),
                        "mlstm.w_gates": (d, 2 * self.n_heads),
                        "mlstm.w_o": (di, d),
                    })
                if self.d_ff:
                    shapes["ffn.w_gate"] = (d, self.d_ff)
                    shapes["ffn.w_up"] = (d, self.d_ff)
                    shapes["ffn.w_down"] = (self.d_ff, d)
                return shapes
            shapes.update(self._mamba_shapes())
            return shapes
        if self.family == "hybrid" and not self.is_attention_layer(layer):
            shapes.update(self._mamba_shapes())
        elif self.kda is not None and not self.is_attention_layer(layer):
            shapes.update(self._kda_shapes())
        else:
            if self.mla is not None:
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                if m.q_lora_rank is None:
                    shapes["attn.w_q"] = (d, self.n_heads * qk_head)
                else:
                    shapes["attn.w_dq"] = (d, m.q_lora_rank)
                    shapes["attn.w_uq"] = (m.q_lora_rank,
                                           self.n_heads * qk_head)
                shapes.update({
                    "attn.w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
                    "attn.w_ukv": (m.kv_lora_rank,
                                   self.n_heads * (m.qk_nope_head_dim
                                                   + m.v_head_dim)),
                    "attn.w_o": (self.n_heads * m.v_head_dim, d),
                })
            else:
                shapes.update({
                    "attn.w_q": (d, self.q_dim),
                    "attn.w_k": (d, self.kv_dim),
                    "attn.w_v": (d, self.kv_dim),
                    "attn.w_o": (self.q_dim, d),
                })
        if self.is_moe_layer(layer):
            e = self.moe
            shapes["moe.w_router"] = (d, e.n_experts)
            for i in range(e.n_held):
                shapes[f"moe.expert{i}.w_gate"] = (d, e.d_ff_expert)
                shapes[f"moe.expert{i}.w_up"] = (d, e.d_ff_expert)
                shapes[f"moe.expert{i}.w_down"] = (e.d_ff_expert, d)
            for i in range(e.n_shared):
                shapes[f"moe.shared{i}.w_gate"] = (d, e.d_ff_expert)
                shapes[f"moe.shared{i}.w_up"] = (d, e.d_ff_expert)
                shapes[f"moe.shared{i}.w_down"] = (e.d_ff_expert, d)
        elif self.d_ff:
            if self.gated_act in ("swiglu", "geglu"):
                shapes["ffn.w_gate"] = (d, self.d_ff)
            shapes["ffn.w_up"] = (d, self.d_ff)
            shapes["ffn.w_down"] = (self.d_ff, d)
        return shapes

    def _mamba_shapes(self) -> dict[str, tuple]:
        s = self.ssm or SSMConfig()
        d = self.d_model
        di = s.d_inner(d)
        dtr = s.dt_rank_for(d)
        return {
            "ssm.w_in_x": (d, di),
            "ssm.w_in_z": (d, di),
            "ssm.w_dt_in": (di, dtr),
            "ssm.w_dt": (dtr, di),
            "ssm.w_out": (di, d),
        }

    def _kda_shapes(self) -> dict[str, tuple]:
        k, d = self.kda, self.d_model
        w, r = k.width, k.head_dim
        shapes = {f"kda.w_{x}": (d, w) for x in "qkv"}
        shapes.update({f"kda.conv_{x}": (k.conv_kernel, w) for x in "qkv"})
        shapes.update({"kda.w_fa": (d, r), "kda.w_fb": (r, w),
                       "kda.w_b": (d, k.n_heads), "kda.w_ga": (d, r),
                       "kda.w_gb": (r, w), "kda.w_o": (w, d)})
        return shapes

    @staticmethod
    def class_of_param(name: str) -> str:
        """Pool shape class of a streamed tensor (paper §IV-B grouping)."""
        short = name.rsplit("/", 1)[-1]
        if short.startswith(("embed", "head", "lm_head")):
            return "embed"
        if ".expert" in short or ".shared" in short:
            return "expert"
        if short.startswith("ffn.") or short.startswith("moe.w_router"):
            return "ffn" if short.startswith("ffn.") else "router"
        if short.startswith("ssm.") or short.startswith("mlstm.") \
                or short.startswith("slstm."):
            return "ssm"
        if short.startswith("attn.") or short in ("kda.w_q", "kda.w_k",
                                                  "kda.w_v", "kda.w_o"):
            # paper: K/V identical under GQA get one subpool; Q/O another
            if short in ("attn.w_k", "attn.w_v", "kda.w_k", "kda.w_v"):
                return "kv_proj"
            return "qo_proj"
        if short.startswith("kda."):
            return "ssm"      # the linear recurrence's own gates and taps
        return "other"

    def pool_census(self, *, inflight_blocks: int = 2, shards: int = 1):
        """Shape-class census across all layers (for the pool benchmarks)."""
        from repro_torch.core.buffer_pool import PoolCensus, ShapeClass
        bytes_per = 2  # streamed in 16-bit compute precision
        nbytes: dict[str, int] = {}
        per_block: dict[str, int] = {}
        period = max(self.attn_period, self.moe_period)
        if self.kda is not None:
            period = self.n_layers
        if self.ssm is not None and self.ssm.kind == "xlstm":
            period = max(period, self.ssm.slstm_every)
        lead = self.first_dense_layers
        for layer in set(range(min(self.n_layers, lead + period))):
            counts: dict[str, int] = {}
            for pname, shape in self.block_param_shapes(layer).items():
                cls = self.class_of_param(pname)
                counts[cls] = counts.get(cls, 0) + 1
                nbytes[cls] = max(nbytes.get(cls, 0),
                                  math.prod(shape) * bytes_per)
            for cls, c in counts.items():
                per_block[cls] = max(per_block.get(cls, 0), c)
        embed_bytes = self.vocab * self.d_model * bytes_per
        nbytes["embed"] = max(nbytes.get("embed", 0), embed_bytes)
        standalone = {"embed": 1 if self.tie_embeddings else 2}  # embed + head
        classes = [ShapeClass(c, -(-nbytes[c] // shards),
                              per_block.get(c, 0), standalone.get(c, 0))
                   for c in sorted(nbytes)]
        return PoolCensus(tuple(classes), inflight_blocks)

    def param_count(self, *, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, embeddings included."""
        total = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        for layer in range(self.n_layers):
            for pname, shape in self.block_param_shapes(layer).items():
                if active_only and ".expert" in pname and self.moe:
                    continue
                total += math.prod(shape)
            total += 2 * self.d_model  # norms
        if active_only and self.moe:
            e = self.moe
            per_expert = (self.d_model * 2 * e.d_ff_expert
                          + e.d_ff_expert * self.d_model)
            moe_layers = sum(map(self.is_moe_layer, range(self.n_layers)))
            total += moe_layers * e.top_k * per_expert
        if self.encoder_layers:
            enc_block = (4 * self.d_model * self.q_dim
                         + 2 * self.d_model * self.d_ff)
            total += self.encoder_layers * enc_block
        return total

    # -- reduced smoke variant ------------------------------------------------------

    def reduced(self) -> "ModelConfig":
        """≤2-layer, d_model ≤ 256 variant of the same family for CPU smoke."""
        d = 128
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, max(1, heads // 2)) if self.n_kv_heads > 1 else 1
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2 if self.family != "hybrid" else self.attn_period,
            d_model=d, n_heads=heads, n_kv_heads=kv,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=d // heads if self.mla is None else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window
            else 0,
        )
        if self.family == "hybrid":
            kw["n_layers"] = self.attn_period  # one full interleave group
        if self.moe:
            kw["moe"] = replace(self.moe, n_experts=4, top_k=2,
                                d_ff_expert=128)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=64,
                                  q_lora_rank=self.mla.q_lora_rank and 96,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
            kw["head_dim"] = 0
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=8, chunk=32)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 64
            kw["max_decode_len"] = self.max_decode_len
        if self.prefix_len:
            kw["prefix_len"] = 16
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
