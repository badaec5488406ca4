"""Unified model configuration covering all assigned architecture families.

A model is a stack of (mixer, mlp) residual blocks described by a repeating
``pattern``.  Pattern entries:

  "g"      global causal attention + dense MLP
  "l"      local (sliding-window) attention + dense MLP
  "g:moe"  global attention + MoE MLP
  "l:moe"  local attention + MoE MLP
  "r"      RG-LRU recurrent block (Griffin) + dense MLP
  "m"      Mamba-1 selective-SSM block (no separate MLP)

The stack is ``n_layers`` long: ``n_layers // len(pattern)`` full repeats of
the pattern plus an explicit remainder.

A copy of the reference's ``repro.models.config`` in which the dtype names
map to ``torch.float32`` / ``torch.bfloat16``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    o_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0                # sliding window for "l" layers
    causal: bool = True            # False -> encoder (bidirectional, no cache)
    # mlp
    d_ff: int = 0
    gated_mlp: bool = True
    mlp_bias: bool = False
    activation: str = "silu"       # silu | gelu
    # layer pattern
    pattern: Tuple[str, ...] = ("g",)
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert: bool = False
    router: str = "softmax"        # softmax | sigmoid
    capacity_factor: float = 1.25
    # §Perf knob: shard expert FFN dim on fsdp (weights resident — no
    # per-layer FSDP gather; activations all-reduce instead)
    moe_shard_ff: bool = False
    # ssm (mamba) / rglru (griffin)
    d_inner: int = 0
    ssm_state: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    lru_width: int = 0
    # §Perf knobs for the selective-scan path
    ssm_scan_dtype: str = "float32"   # bf16 halves scan HBM traffic
    ssm_chunk: int = 256              # assoc-scan chunk (log-factor levels)
    ssm_impl: str = "assoc"           # assoc | noscan (traffic isolation)
    # §Perf knob for attention: "online" (XLA online-softmax baseline) or
    # "iso" (I/O-preserving linear-attention stand-in: measures the model
    # *minus* the score-block traffic the Pallas flash kernel eliminates)
    attn_impl: str = "online"
    # embeddings / frontends
    tie_embeddings: bool = True
    padded_vocab: int = 0          # 0 -> auto-pad to a multiple of 128
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_image_embeds: int = 0        # vision_stub: patch embeddings per sample
    embed_scale: bool = False      # gemma-style sqrt(d) embedding scaling
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # applicability
    supports_decode: bool = True
    supports_long_context: bool = False
    remat: bool = True

    # ---- derived ----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def v_pad(self) -> int:
        if self.padded_vocab:
            return self.padded_vocab
        return ((self.vocab + 127) // 128) * 128

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers - self.n_units * len(self.pattern)]

    def entry(self, e: str) -> Tuple[str, str]:
        """Split a pattern entry into (mixer_kind, mlp_kind)."""
        mixer, _, tag = e.partition(":")
        if mixer == "m":
            return "mamba", "none"
        if mixer == "r":
            return "rglru", "moe" if tag == "moe" else "dense"
        kind = {"g": "attn_g", "l": "attn_l"}[mixer]
        return kind, ("moe" if tag == "moe" else "dense")

    def validate(self) -> None:
        assert self.n_layers >= len(self.pattern)
        for e in self.pattern:
            self.entry(e)
        if any("moe" in e for e in self.pattern):
            assert self.n_experts > 0 and self.top_k > 0 and self.d_ff_expert > 0
        if any(e.startswith("m") for e in self.pattern):
            assert self.d_inner > 0 and self.ssm_state > 0
        if any(e.startswith("r") for e in self.pattern):
            assert self.lru_width > 0


def reduced(cfg: ModelConfig, **over) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    pat = cfg.pattern
    base = dict(
        name=cfg.name + "-smoke",
        n_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
        d_model=64,
        vocab=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        pattern=pat,
        window=min(cfg.window, 8) if cfg.window else 0,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        shared_expert=cfg.shared_expert,
        router=cfg.router,
        d_inner=32 if cfg.d_inner else 0,
        ssm_state=min(cfg.ssm_state, 4) if cfg.ssm_state else 0,
        dt_rank=8 if cfg.dt_rank else 0,
        lru_width=32 if cfg.lru_width else 0,
        conv_width=cfg.conv_width,
        qkv_bias=cfg.qkv_bias,
        o_bias=cfg.o_bias,
        qk_norm=cfg.qk_norm,
        gated_mlp=cfg.gated_mlp,
        mlp_bias=cfg.mlp_bias,
        activation=cfg.activation,
        causal=cfg.causal,
        frontend=cfg.frontend,
        n_image_embeds=8 if cfg.n_image_embeds else 0,
        embed_scale=cfg.embed_scale,
        tie_embeddings=cfg.tie_embeddings,
        supports_decode=cfg.supports_decode,
        supports_long_context=cfg.supports_long_context,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    base.update(over)
    return ModelConfig(**base)
