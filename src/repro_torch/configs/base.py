"""Model / shape / mesh configuration dataclasses.

Every assigned architecture gets one module in this package that exports a
``CONFIG`` (full-size, exercised only via the dry-run) and a ``REDUCED``
variant (2 layers, d_model <= 512, <= 4 experts) used by CPU smoke tests
and the runnable examples.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (routed + optional shared)."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "tp": experts tensor-sharded over model axis (no all-to-all).
    # "ep": experts sharded over model axis with all-to-all dispatch.
    # "gather": capacity-free per-token top-k gather dispatch
    # (models.moe.moe_ffn_gather) — batch-composition invariant, so
    # the serving engine may compact/page MoE members; denser compute.
    impl: str = "tp"
    # Layer index of the first MoE layer (earlier layers use dense FFN,
    # deepseek-v2 keeps layer 0 dense).
    first_moe_layer: int = 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective-state-space block configuration."""

    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # chunked-scan block length


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block configuration."""

    lru_width: int = 0        # 0 -> d_model
    conv_width: int = 4
    expand: int = 3           # width multiple of the gated MLP branch
    chunk: int = 256


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder models (whisper)."""

    num_layers: int
    num_frames: int           # frontend output length (e.g. 1500 mel frames)
    d_frontend: int           # frontend embedding dim (== d_model for stub)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    # attention
    attn_kind: str = "gqa"    # gqa | mla | none
    window: Optional[int] = None          # sliding-window size (SWA / local attn)
    rope_theta: float = 10_000.0
    use_rope: bool = True                 # whisper uses learned positions
    max_position: int = 1 << 20
    # per-layer pattern for hybrid models, e.g. ("rglru", "rglru", "attn");
    # tiled cyclically over num_layers.
    layer_pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None        # None | "audio" | "vision"
    num_patches: int = 0                  # vision frontend: image token prefix
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # remat policy for training: "none" | "layer"
    remat: str = "layer"
    # scan over stacked layer params (bounded HLO). False = unrolled
    # python loop — used by the dry-run's cost-exact compiles, since
    # XLA cost analysis counts a while body once (models/scan_flags.py).
    scan_layers: bool = True
    use_pallas: bool = False              # TPU deployment flag (kernels/)
    # int8 KV cache (symmetric per-vector quant over head_dim): halves
    # decode's cache-read traffic and storage (EXPERIMENTS.md §Perf C2).
    kv_quant: bool = False
    source: str = ""                      # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none"

    @property
    def supports_long_context(self) -> bool:
        """True if decode memory/time per step is sub-linear in history.

        SSM / hybrid (bounded local window) / SWA architectures qualify;
        pure full-attention architectures do not.
        """
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind tuple of length num_layers."""
        if self.layer_pattern is None:
            if self.family == "ssm":
                return ("ssm",) * self.num_layers
            return ("attn",) * self.num_layers
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter accounting (used by roofline + tests) ----------------
    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # input embedding
        if not self.tie_embeddings:
            total += v * d                 # lm head
        hd = self.resolved_head_dim
        for idx, kind in enumerate(self.layer_kinds):
            total += 2 * d                 # pre-norms (attn/mlp) approx
            if kind == "attn":
                if self.attn_kind == "mla":
                    m = self.mla
                    assert m is not None
                    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank
                    total += m.q_lora_rank * self.num_heads * qk_dim
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.num_heads * m.v_head_dim * d
                else:
                    total += d * self.num_heads * hd          # Q
                    total += 2 * d * self.num_kv_heads * hd   # K, V
                    total += self.num_heads * hd * d          # O
            elif kind == "ssm":
                s = self.ssm
                assert s is not None
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                total += d * 2 * d_in                 # in_proj (x, z)
                total += d_in * s.conv_width          # conv
                total += d_in * (dt_rank + 2 * s.state_dim)  # x_proj
                total += dt_rank * d_in + d_in        # dt_proj
                total += d_in * s.state_dim           # A_log
                total += d_in                         # D
                total += d_in * d                     # out_proj
            elif kind == "rglru":
                r = self.rglru
                assert r is not None
                w = r.lru_width or d
                total += 2 * d * w                    # in (x, gate branch)
                total += w * r.conv_width
                total += 3 * w                        # a param + gates (diag-ish)
                total += 2 * w * w                    # input/recurrence gates
                total += w * d                        # out
            if kind != "ssm":
                # MLP (mamba blocks have no separate MLP)
                total += self._mlp_params(idx)
        # encoder stack
        if self.encoder is not None:
            e = self.encoder
            for _ in range(e.num_layers):
                total += 2 * d
                total += 4 * d * self.num_heads * hd      # MHA
                total += 3 * d * self.d_ff                # swiglu-ish
            total += e.num_frames * d                     # learned positions
        return total

    def _mlp_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is not None and layer_idx >= self.moe.first_moe_layer:
            m = self.moe
            routed = m.num_experts * 3 * d * m.d_ff_expert
            shared = m.num_shared_experts * 3 * d * m.d_ff_shared
            router = d * m.num_experts
            return routed + shared + router
        return 3 * d * self.d_ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        total = self.param_count()
        # subtract inactive routed experts
        n_moe_layers = sum(
            1 for i, k in enumerate(self.layer_kinds)
            if k == "attn" and i >= m.first_moe_layer)
        inactive = (m.num_experts - m.top_k) * 3 * d * m.d_ff_expert
        return total - n_moe_layers * inactive


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
