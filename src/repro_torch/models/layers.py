"""Core layers: RMSNorm, RoPE, GQA attention, dense/gated MLP, embedding
and LM head — the reference's ``repro.models.layers`` in PyTorch.

Parameters are any mapping of name -> tensor (an ``nn.ParameterDict`` or a
plain dict).  Every function mirrors the reference's dtype casts, so a
bf16-compute model rounds where the reference rounds: projections in the
compute dtype, norms and RoPE in float32 and back, attention scores and
softmax in float32.  Sharding constraints have no counterpart here (one
device).

Prefill and train-mode attention go through the flash-attention kernel
(``kernels/flash_attention``): on the card the hand-written CUDA kernel, on
the CPU its plain version, and on the CPU above 2048 tokens the blocked
online-softmax version :func:`_attn_online` (as the reference switches from
``_attn_dense``).  Decode attention, one query per session against the
cache, is plain PyTorch, as in the reference it is plain XLA.

Not ported yet: the MoE MLP and the training loss (ROADMAP queue 1 item 12).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as flash_ops

NOT_PORTED_12 = "is not ported yet (ROADMAP queue 1 item 12)"


# ---------------------------------------------------------------------------
# initializers


def _dense_init(gen: torch.Generator, shape, dtype, fan_in=None,
                device=None) -> torch.Tensor:
    """Truncated normal at +-2 sigma, scaled by 1/sqrt(fan_in) (fan_in
    defaults to the second-to-last dim), drawn in float32 from ``gen``."""
    fan_in = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(fan_in))).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm


def rmsnorm_init(cfg, dim=None, device=None):
    return {"scale": torch.ones((dim or cfg.d_model,), dtype=cfg.pdtype,
                                device=device)}


def rmsnorm(p, x, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S) int.  The head is split in
    halves (not interleaved)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, optional qk-norm)


def attn_init(cfg, gen, device=None):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.pdtype
    p = {
        "wq": _dense_init(gen, (D, H * hd), pd, device=device),
        "wk": _dense_init(gen, (D, KV * hd), pd, device=device),
        "wv": _dense_init(gen, (D, KV * hd), pd, device=device),
        "wo": _dense_init(gen, (H * hd, D), pd, fan_in=H * hd, device=device),
    }
    z = lambda n: torch.zeros((n,), dtype=pd, device=device)  # noqa: E731
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = z(H * hd), z(KV * hd), z(KV * hd)
    if cfg.o_bias:
        p["bo"] = z(D)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=pd, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=pd, device=device)
    return p


def _qk_normalize(q, k, p, eps):
    def nrm(x, scale):
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
        return (y * scale.float()).to(x.dtype)
    return nrm(q, p["q_norm"]), nrm(k, p["k_norm"])


def _mask(q_pos, k_pos, window):
    """(..., S, T) boolean validity mask. q_pos/k_pos broadcastable."""
    m = (k_pos[..., None, :] <= q_pos[..., :, None]) & \
        (k_pos[..., None, :] >= 0)
    if window:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return m


def _attn_dense(q, k, v, q_pos, k_pos, window, causal=True):
    """q: (B,S,KV,G,hd)  k,v: (B,T,KV,hd).  Returns (B,S,KV,G,hd).
    Products in float32 (the reference's ``preferred_element_type``), the
    softmax weights rounded to v's dtype before the value product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if causal:
        valid = _mask(q_pos, k_pos, window)          # (B?,S,T) or (S,T)
        valid = valid[..., None, None, :, :] if valid.dim() == 3 else valid
        s = torch.where(valid, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _attn_online(q, k, v, q_pos, k_pos, window, causal=True, blk=1024):
    """Online-softmax attention over KV blocks of ``blk``: never holds the
    full (S, T) score matrix.  The plain version for long prompts on the
    CPU."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    nblk = (T + blk - 1) // blk
    Tp = nblk * blk
    if Tp != T:
        k = F.pad(k, (0, 0, 0, 0, 0, Tp - T))
        v = F.pad(v, (0, 0, 0, 0, 0, Tp - T))
        k_pos = F.pad(k_pos, (0, Tp - T), value=torch.iinfo(torch.int32).max)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float()
    m = torch.full((B, KV, G, S), -math.inf, device=q.device)
    d = torch.zeros((B, KV, G, S), device=q.device)
    acc = torch.zeros((B, KV, G, S, hd), device=q.device)
    for j in range(nblk):
        kj, vj = k[:, j * blk:(j + 1) * blk], v[:, j * blk:(j + 1) * blk]
        pj = k_pos[j * blk:(j + 1) * blk]
        s = torch.einsum("bskgh,btkh->bkgst", qf, kj.float()) * scale
        if causal:
            valid = _mask(q_pos, pj, window)          # (S, blk)
            s = torch.where(valid[None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        d = d * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bkgsh", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / d.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)        # (B,S,KV,G,hd)


def _prefill_attention(cfg, qg, k, v, q_pos, window):
    """Full-sequence attention of prefill and train mode: the flash kernel
    (or, for a CPU tensor, its plain version; above 2048 tokens on the
    CPU, :func:`_attn_online`)."""
    causal = bool(cfg.causal)
    window = window if causal else 0
    if qg.device.type == "cpu" and qg.shape[1] > 2048:
        return _attn_online(qg, k, v, q_pos, q_pos, window, causal=causal)
    return flash_ops.flash_attention(qg, k, v, causal=causal, window=window)


def _cache_write(cache, new, pos, write):
    """In place: ``cache[b, pos[b]] = new[b]`` for every row whose
    ``write`` is set and whose ``pos`` lies inside the cache; the other
    rows keep what they hold.  The reference's scatter drops a write at
    ``pos == max_seq``; a select over the written row does the same here
    without a host branch or an out-of-range index."""
    B, W = cache.shape[0], cache.shape[1]
    bidx = torch.arange(B, device=cache.device)
    idx = pos.clamp(0, W - 1)
    ok = (pos >= 0) & (pos < W)
    if write is not None:
        ok = ok & write
    old = cache[bidx, idx]
    cache[bidx, idx] = torch.where(ok[:, None, None], new.to(cache.dtype),
                                   old)


def attn_apply(cfg, p: Mapping[str, torch.Tensor], x, *, mode, window,
               cache=None, pos=None, write=None):
    """Full attention layer.  mode: train|prefill|decode.

    cache (decode): {"k","v"}: (B, S_max, KV, hd), updated **in place**
    (the reference returns a new cache; the port writes one row per
    session into the one it is given).  pos: (B,) per-session positions
    or a scalar int.  write: optional (B,) or () bool — rows whose cache
    write is kept (the serving tile's skipped step); None keeps all.
    Returns (y, new_cache)."""
    if cfg.attn_impl != "online":
        raise NotImplementedError(f"attn_impl={cfg.attn_impl!r} (the "
                                  f"reference's measurement-only variant) "
                                  f"{NOT_PORTED_12}")
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // KV
    cd = cfg.cdtype
    xq = x.to(cd)

    def proj(w, b=None):
        y = xq @ p[w].to(cd)
        if b and b in p:
            y = y + p[b].to(cd)
        return y

    q = proj("wq", "bq").reshape(B, S, H, hd)
    k = proj("wk", "bk").reshape(B, S, KV, hd)
    v = proj("wv", "bv").reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q, k = _qk_normalize(q, k, p, cfg.norm_eps)

    if mode == "decode":
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        vec_pos = pos.dim() == 1
        q_pos = pos[:, None] if vec_pos else pos.reshape(1)
    else:
        q_pos = torch.arange(S, dtype=torch.int32, device=x.device)
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)

    new_cache = cache
    qg = q.reshape(B, S, KV, G, hd)
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        W = cache["k"].shape[1]
        if window and W == min(window, W):
            # rolling window cache: slots always hold the last W positions
            k_all = torch.cat([cache["k"][:, 1:], k.to(cache["k"].dtype)], 1)
            v_all = torch.cat([cache["v"][:, 1:], v.to(cache["v"].dtype)], 1)
            if write is not None:
                keep = write.reshape(-1, 1, 1, 1)
                k_all = torch.where(keep, k_all, cache["k"])
                v_all = torch.where(keep, v_all, cache["v"])
            cache["k"].copy_(k_all)
            cache["v"].copy_(v_all)
            rel = torch.arange(W, dtype=torch.int32, device=x.device) - (W - 1)
            k_pos = (pos[:, None] + rel[None, :]) if vec_pos else pos + rel
        else:
            posv = pos if vec_pos else pos.expand(B)
            wr = None if write is None else write.expand(B)
            _cache_write(cache["k"], k[:, 0], posv, wr)
            _cache_write(cache["v"], v[:, 0], posv, wr)
            k_all, v_all = cache["k"], cache["v"]
            k_pos = torch.arange(W, dtype=torch.int32, device=x.device)
            if vec_pos:
                k_pos = k_pos.expand(B, W)
        o = _attn_dense(qg, k_all.to(cd), v_all.to(cd), q_pos, k_pos, window)
    else:
        if mode == "prefill":
            kc, vc = k.to(cd), v.to(cd)
            if window and S >= window:
                kc, vc = kc[:, -window:], vc[:, -window:]
            new_cache = {"k": kc, "v": vc}
        o = _prefill_attention(cfg, qg, k, v, q_pos, window)

    o = o.reshape(B, S, H * hd)
    y = o @ p["wo"].to(cd)
    if "bo" in p:
        y = y + p["bo"].to(cd)
    return y.to(x.dtype), new_cache


def attn_cache_shape(cfg, batch, max_seq, device=None):
    KV, hd = cfg.n_kv_heads, cfg.hd
    z = lambda: torch.zeros((batch, max_seq, KV, hd),  # noqa: E731
                            dtype=cfg.cdtype, device=device)
    return {"k": z(), "v": z()}


# ---------------------------------------------------------------------------
# Dense MLP (gated or plain)


def mlp_init(cfg, gen, d_ff=None, device=None):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.pdtype
    w_in = _dense_init(gen, (D, Fd), pd, device=device)
    p = {"w_in": w_in}
    if cfg.gated_mlp:
        p["w_gate"] = _dense_init(gen, (D, Fd), pd, device=device)
    p["w_out"] = _dense_init(gen, (Fd, D), pd, fan_in=Fd, device=device)
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((Fd,), dtype=pd, device=device)
        p["b_out"] = torch.zeros((D,), dtype=pd, device=device)
    return p


def _act(name):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp_apply(cfg, p, x):
    cd = cfg.cdtype
    xc = x.to(cd)
    h = xc @ p["w_in"].to(cd)
    if "b_in" in p:
        h = h + p["b_in"].to(cd)
    if cfg.gated_mlp:
        g = xc @ p["w_gate"].to(cd)
        h = _act(cfg.activation)(g) * h
    else:
        h = _act(cfg.activation)(h)
    y = h @ p["w_out"].to(cd)
    if "b_out" in p:
        y = y + p["b_out"].to(cd)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MoE MLP: not ported


def moe_init(cfg, gen, device=None):
    raise NotImplementedError(f"the MoE MLP {NOT_PORTED_12}")


def moe_apply(cfg, p, x):
    raise NotImplementedError(f"the MoE MLP {NOT_PORTED_12}")


# ---------------------------------------------------------------------------
# Embedding / LM head


def embed_init(cfg, gen, device=None):
    p = {"table": _dense_init(gen, (cfg.v_pad, cfg.d_model), cfg.pdtype,
                              fan_in=cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, (cfg.d_model, cfg.v_pad), cfg.pdtype,
                                device=device)
    return p


def embed_apply(cfg, p, tokens):
    """Rows of the table for ``tokens``, in the compute dtype.  As the
    reference's ``jnp.take``: a negative token counts from the end, and a
    token still out of range gives a row of NaN (no index error, no host
    branch)."""
    table = p["table"]
    V = table.shape[0]
    tok = tokens.to(torch.int64)
    tok = torch.where(tok < 0, tok + V, tok)
    inside = (tok >= 0) & (tok < V)
    h = table[tok.clamp(0, V - 1)]
    h = torch.where(inside[..., None], h, math.nan).to(cfg.cdtype)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    return h


def lm_head(cfg, p, h):
    cd = cfg.cdtype
    w = p["table"].to(cd).T if cfg.tie_embeddings else p["head"].to(cd)
    return h.to(cd) @ w


def cross_entropy(cfg, logits, labels):
    raise NotImplementedError(f"training (cross_entropy) {NOT_PORTED_12}")
