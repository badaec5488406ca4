"""Residual block assembly — the reference's ``repro.models.blocks`` for
the attention mixers (``attn_g`` global, ``attn_l`` sliding window) with a
dense MLP.

A block is pre-norm: ``x + mixer(norm1(x))``, then ``x + mlp(norm2(x))``.
``mode`` is "train" | "prefill" | "decode" as in :mod:`layers`.

Not ported yet, and refused by name: the RG-LRU mixer (Griffin), the
Mamba-1 mixer (item 13 of ROADMAP queue 1, the next slice, onto the Mamba
scan kernel) and the MoE MLP (item 12).
"""
from __future__ import annotations

from repro_torch.models import layers as L

NOT_PORTED = {
    "rglru": "the RG-LRU mixer is not ported yet (ROADMAP queue 1 item 12)",
    "mamba": "the Mamba-1 mixer is not ported yet (ROADMAP queue 1 item 13, "
             "the Mamba-1 path)",
    "moe": "the MoE MLP is not ported yet (ROADMAP queue 1 item 12)",
}


def _check_ported(cfg, entry):
    mixer, mlp = cfg.entry(entry)
    for part in (mixer, mlp):
        if part in NOT_PORTED:
            raise NotImplementedError(NOT_PORTED[part])
    return mixer, mlp


def block_init(cfg, entry, gen, device=None):
    mixer, mlp = _check_ported(cfg, entry)
    p = {"norm1": L.rmsnorm_init(cfg, device=device),
         "mixer": L.attn_init(cfg, gen, device=device)}
    if mlp == "dense":
        p["norm2"] = L.rmsnorm_init(cfg, device=device)
        p["mlp"] = L.mlp_init(cfg, gen, d_ff=cfg.d_ff, device=device)
    return p


def block_cache(cfg, entry, batch, max_seq, device=None):
    """Zero cache for one block.  Local-attn caches are window-sized."""
    mixer, _ = _check_ported(cfg, entry)
    if mixer == "attn_g":
        return L.attn_cache_shape(cfg, batch, max_seq, device=device)
    return L.attn_cache_shape(cfg, batch, min(max_seq, cfg.window),
                              device=device)


def block_apply(cfg, entry, p, x, *, mode, cache=None, pos=None,
                write=None):
    mixer, mlp = _check_ported(cfg, entry)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    window = cfg.window if mixer == "attn_l" else 0
    y, new_cache = L.attn_apply(cfg, p["mixer"], h, mode=mode, window=window,
                                cache=cache, pos=pos, write=write)
    x = x + y
    if mlp == "dense":
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(cfg, p["mlp"], h2)
    return x, new_cache
