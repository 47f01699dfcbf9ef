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


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims [arXiv:2412.19437]."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


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
    attn_period: int = 1         # hybrid: 1 attention layer per this many
                                 # (jamba: 8 -> layers i%8==0 are attention)
    moe_period: int = 1          # MoE FFN every this many layers (jamba: 2);
                                 # other layers get a dense FFN of d_ff
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

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_attention_layer(self, i: int) -> bool:
        """Hybrid interleave: which layers are attention (vs SSM)."""
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
        else:
            if self.mla is not None:
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                shapes.update({
                    "attn.w_dq": (d, m.q_lora_rank),
                    "attn.w_uq": (m.q_lora_rank, self.n_heads * qk_head),
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
        if self.moe is not None and layer % self.moe_period == self.moe_period - 1:
            e = self.moe
            shapes["moe.w_router"] = (d, e.n_experts)
            for i in range(e.n_experts):
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
        if short.startswith("attn."):
            # paper: K/V identical under GQA get one subpool; Q/O another
            if short in ("attn.w_k", "attn.w_v"):
                return "kv_proj"
            return "qo_proj"
        return "other"

    def pool_census(self, *, inflight_blocks: int = 2, shards: int = 1):
        """Shape-class census across all layers (for the pool benchmarks)."""
        from repro_torch.core.buffer_pool import PoolCensus, ShapeClass
        bytes_per = 2  # streamed in 16-bit compute precision
        nbytes: dict[str, int] = {}
        per_block: dict[str, int] = {}
        period = max(self.attn_period, self.moe_period)
        if self.ssm is not None and self.ssm.kind == "xlstm":
            period = max(period, self.ssm.slstm_every)
        for layer in set(range(min(self.n_layers, period))):
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
            moe_layers = self.n_layers // self.moe_period
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
            kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
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
