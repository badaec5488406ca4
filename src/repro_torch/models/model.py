"""Model engine: the reference's ``repro.models.model`` in PyTorch.

Parameters are a :class:`Params` module.  Its ``state_dict`` keys name the
reference's pytree paths, with the reference's stacked ``units`` axis
unrolled into one block module per layer::

    embed.table            embed.head (untied)       final_norm.scale
    units.p<i>.<u>.norm1.scale   units.p<i>.<u>.mixer.wq ...  (layer u of
                                 pattern position i)
    rem.<j>....            (remainder layers)

The reference scans over the units; here a Python loop runs the layers.
Caches keep the reference's stacked layout — every leaf under
``cache["units"]["p<i>"]`` has a leading ``n_units`` axis — so a whole
cache compares with the reference's leaf for leaf.  Decode updates the
cache it is given in place (one row per session per layer).

Entry points run on the card unless the caller asks for the CPU
(``init_params(..., device="cpu")``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.core.compiler import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

# parameters kept in fp32 even when compute is bf16 (numerics-sensitive)
_KEEP_F32 = {"lam", "A_log", "dt_bias", "D_skip", "router"}


def _pdict(tree: Dict[str, Any]) -> nn.Module:
    """Nested dict of tensors -> ModuleDict / ParameterDict (frozen)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _pdict(v) for k, v in tree.items()})


def _plain(mod: nn.Module) -> Dict[str, Any]:
    """ModuleDict / ParameterDict -> nested dict of tensors."""
    if isinstance(mod, nn.ParameterDict):
        return {k: v for k, v in mod.items()}
    return {k: _plain(v) for k, v in mod.items()}


class Params(nn.Module):
    """The model's parameters: ``embed``, ``units`` (one block module per
    layer, by pattern position), ``rem`` and ``final_norm``.

    ``tree`` holds the blocks of pattern position i as a list of
    ``n_units`` dicts under ``tree["units"]["p<i>"]``."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__()
        self.embed = _pdict(tree["embed"])
        self.units = nn.ModuleDict({
            k: nn.ModuleList([_pdict(b) for b in blocks])
            for k, blocks in tree["units"].items()})
        self.rem = nn.ModuleList([_pdict(b) for b in tree["rem"]])
        self.final_norm = _pdict(tree["final_norm"])
        self._compute: Dict[torch.dtype, Dict[str, Any]] = {}

    def for_compute(self, cfg: ModelConfig) -> Dict[str, Any]:
        """The block parameters as :func:`_cast_for_compute` gives them,
        cast once and kept (inference only: the parameters never change
        after they are made)."""
        if cfg.cdtype not in self._compute:
            self._compute[cfg.cdtype] = {
                "units": {k: [_cast_for_compute(cfg, _plain(b)) for b in bs]
                          for k, bs in self.units.items()},
                "rem": [_cast_for_compute(cfg, _plain(b)) for b in self.rem]}
        return self._compute[cfg.cdtype]

    def _apply(self, fn, *args, **kwargs):
        self._compute = {}          # moved or cast: cast again at next use
        return super()._apply(fn, *args, **kwargs)


# ---------------------------------------------------------------------------
# init


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Seeded initialisation (the reference's init distributions, drawn
    from one ``torch.Generator`` on ``device``; default: the card)."""
    cfg.validate()
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    units = {f"p{i}": [B.block_init(cfg, e, gen, device=device)
                       for _ in range(cfg.n_units)]
             for i, e in enumerate(cfg.pattern)}
    rem = [B.block_init(cfg, e, gen, device=device) for e in cfg.remainder]
    tree = {"embed": L.embed_init(cfg, gen, device=device), "units": units,
            "rem": rem, "final_norm": L.rmsnorm_init(cfg, device=device)}
    return Params(cfg, tree)


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero cache in the stacked layout: ``{"units": {"p<i>": {"k", "v"}:
    (n_units, batch, T, KV, hd)}, "rem": [...]}``."""
    device = resolve_device(device)
    units = {}
    for i, entry in enumerate(cfg.pattern):
        one = B.block_cache(cfg, entry, batch, max_seq, device=device)
        units[f"p{i}"] = {k: torch.zeros((cfg.n_units,) + tuple(t.shape),
                                         dtype=t.dtype, device=device)
                          for k, t in one.items()}
    rem = [B.block_cache(cfg, e, batch, max_seq, device=device)
           for e in cfg.remainder]
    return {"units": units, "rem": rem}


# ---------------------------------------------------------------------------
# embedding


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} front end "
                                  f"{L.NOT_PORTED_12}")
    return L.embed_apply(cfg, params.embed, batch["tokens"])


# ---------------------------------------------------------------------------
# forward (train / prefill)


def _cast_for_compute(cfg: ModelConfig, tree):
    """Matrix parameters in the compute dtype, except those named in
    ``_KEEP_F32``; vectors (norm scales, biases) stay as they are."""
    cd = cfg.cdtype
    if cd == torch.float32:
        return tree

    def one(name, x):
        if isinstance(x, dict):
            return {k: one(k, v) for k, v in x.items()}
        if name in _KEEP_F32 or x.dim() < 2 or x.dtype != torch.float32:
            return x
        return x.to(cd)
    return {k: one(k, v) for k, v in tree.items()}


def _run_stack(cfg: ModelConfig, params: Params, h, *, mode, cache=None,
               pos=None, write=None):
    """Returns (h, cache or None).  Prefill returns a new stacked cache;
    decode updates ``cache`` in place and returns it."""
    cp = params.for_compute(cfg)
    new_units = {f"p{i}": [] for i in range(len(cfg.pattern))}
    for u in range(cfg.n_units):
        for i, entry in enumerate(cfg.pattern):
            c = None
            if cache is not None:
                c = {k: t[u] for k, t in cache["units"][f"p{i}"].items()}
            h, nc = B.block_apply(cfg, entry, cp["units"][f"p{i}"][u], h,
                                  mode=mode, cache=c, pos=pos, write=write)
            new_units[f"p{i}"].append(nc)
    new_rem = []
    for j, entry in enumerate(cfg.remainder):
        c = cache["rem"][j] if cache is not None else None
        h, nc = B.block_apply(cfg, entry, cp["rem"][j], h, mode=mode,
                              cache=c, pos=pos, write=write)
        new_rem.append(nc)
    if mode == "train":
        return h, None
    if mode == "decode":
        return h, cache
    units = {k: {n: torch.stack([c[n] for c in cs]) for n in cs[0]}
             for k, cs in new_units.items() if cs}
    return h, {"units": units, "rem": new_rem}


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Full-sequence forward (train mode). Returns logits (B, S, v_pad)."""
    h = _embed_inputs(cfg, params, batch)
    h, _ = _run_stack(cfg, params, h, mode="train")
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return L.lm_head(cfg, params.embed, h)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    raise NotImplementedError(f"training (loss_fn) {L.NOT_PORTED_12}")


# ---------------------------------------------------------------------------
# inference


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Process the prompt; returns (last_token_logits (B, v_pad), cache)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} has no prefill (an encoder)")
    h = _embed_inputs(cfg, params, batch)
    h, cache = _run_stack(cfg, params, h, mode="prefill")
    h = L.rmsnorm(params.final_norm, h[:, -1:], cfg.norm_eps)
    logits = L.lm_head(cfg, params.embed, h)
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache, token, pos,
                write: Optional[torch.Tensor] = None):
    """One decode step.  token: (B,) int; pos: (B,) per-session positions
    or a scalar (cache slot and RoPE position of the incoming token).
    ``cache`` is updated in place; ``write`` ((B,) or () bool) keeps only
    the cache writes of the rows where it is set.  Returns (logits
    (B, v_pad), cache)."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} has no decode step (an encoder)")
    h = L.embed_apply(cfg, params.embed, token[:, None])
    h, cache = _run_stack(cfg, params, h, mode="decode", cache=cache,
                          pos=pos, write=write)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    logits = L.lm_head(cfg, params.embed, h)
    return logits[:, 0], cache


def greedy_token(cfg: ModelConfig, logits):
    """Argmax over the un-padded vocab, as int32."""
    iota = torch.arange(logits.shape[-1], device=logits.device)
    masked = torch.where(iota < cfg.vocab, logits.float(), -torch.inf)
    return masked.argmax(dim=-1).to(torch.int32)
