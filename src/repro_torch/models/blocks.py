"""Mixer blocks and residual block assembly — the reference's
``repro.models.blocks`` for the attention mixers (``attn_g`` global,
``attn_l`` sliding window) with a dense MLP, and the Mamba-1 selective SSM
(``mamba``, falcon-mamba).

A block is pre-norm: ``x + mixer(norm1(x))``, then ``x + mlp(norm2(x))``.
``mode`` is "train" | "prefill" | "decode" as in :mod:`layers`.

The Mamba-1 mixer's prefill and train-mode scan run on the selective-scan
kernel (``kernels/mamba_scan``): on the card the hand-written CUDA kernel,
on the CPU its plain version.  The reference's model calls its own
``linear_recurrence`` there, never its Pallas kernel.  Decode is one conv
step and one recurrence step in plain PyTorch, as in the reference.

Not ported yet, and refused by name: the RG-LRU mixer (Griffin), the MoE
MLP, and the Mamba options ``ssm_scan_dtype="bfloat16"`` and
``ssm_impl="noscan"`` (item 12 of ROADMAP queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import layers as L

NOT_PORTED = {
    "rglru": "the RG-LRU mixer is not ported yet (ROADMAP queue 1 item 12)",
    "moe": "the MoE MLP is not ported yet (ROADMAP queue 1 item 12)",
}


# ---------------------------------------------------------------------------
# causal depthwise temporal conv


def causal_conv(u, w, b=None):
    """u: (B, S, C), w: (W, C): depthwise causal conv along S, summed tap
    by tap in the reference's order."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = pad[:, 0:S] * w[0]
    for j in range(1, W):
        y = y + pad[:, j:j + S] * w[j]
    return y + b if b is not None else y


def conv_step(state, u1, w, b=None):
    """state: (B, W-1, C); u1: (B, 1, C) -> (y1 (B, 1, C), new_state)."""
    full = torch.cat([state, u1], dim=1)                  # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, w)[:, None]
    if b is not None:
        y = y + b
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM

def mamba_init(cfg, gen, device=None):
    D, Di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.dt_rank, cfg.conv_width)
    pd = cfg.pdtype
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(Di, 1)
    dt0 = torch.empty((Di,), dtype=torch.float32, device=device)
    dt0.uniform_(1e-3, 1e-1, generator=gen)
    return {
        "in_proj": L._dense_init(gen, (D, 2 * Di), pd, device=device),
        "conv_w": L._dense_init(gen, (W, Di), pd, fan_in=W, device=device),
        "conv_b": torch.zeros((Di,), dtype=pd, device=device),
        "x_proj": L._dense_init(gen, (Di, R + 2 * N), pd, device=device),
        "dt_proj": L._dense_init(gen, (R, Di), pd, device=device),
        "dt_bias": torch.log(torch.expm1(dt0.clamp_min(1e-4))),
        "A_log": torch.log(A),
        "D_skip": torch.ones((Di,), dtype=torch.float32, device=device),
        "out_proj": L._dense_init(gen, (Di, D), pd, fan_in=Di, device=device),
    }


def mamba_cache(cfg, batch, device=None):
    Di, N, W = cfg.d_inner, cfg.ssm_state, cfg.conv_width
    return {"h": torch.zeros((batch, Di, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, W - 1, Di), dtype=torch.float32,
                                device=device)}


def mamba_apply(cfg, p, x, *, mode, cache=None, write=None):
    """The Mamba-1 mixer.  Projections in and out in the compute dtype;
    the conv, ``x_proj``, ``dt_proj``, softplus, decay and input in
    float32 (on matrices ``_cast_for_compute`` has already rounded); the
    scan output cast to the compute dtype before the gate, as the
    reference casts.

    Train and prefill run the selective-scan op over the sequence (the
    kernel on the card); prefill returns the cache ``{"h": the final
    state (B, Di, N), "conv": the last W-1 pre-conv inputs (B, W-1, Di)}``
    (fewer rows for a shorter prompt, as in the reference).  Decode takes
    one token per row and updates ``cache`` **in place**; ``write`` ((B,)
    or () bool) keeps the new state only where it is set (elsewhere the
    old state stays, the reference's skipped step).  Returns
    (y, new_cache)."""
    if cfg.ssm_scan_dtype != "float32":
        raise NotImplementedError(f"ssm_scan_dtype={cfg.ssm_scan_dtype!r} "
                                  f"(the reference's bf16 associative scan) "
                                  f"{L.NOT_PORTED_12}")
    if cfg.ssm_impl != "assoc":
        raise NotImplementedError(f"ssm_impl={cfg.ssm_impl!r} (the "
                                  f"reference's measurement-only variant) "
                                  f"{L.NOT_PORTED_12}")
    cd = cfg.cdtype
    R, N, W = cfg.dt_rank, cfg.ssm_state, cfg.conv_width
    xz = x.to(cd) @ p["in_proj"].to(cd)
    u, z = xz.chunk(2, dim=-1)
    uf = u.float()
    w = p["conv_w"].float()
    cb = p["conv_b"].float()
    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        u1, conv_state = conv_step(cache["conv"], uf, w, cb)
        u32 = F.silu(u1)                                      # (B, 1, Di)
    else:
        u32 = F.silu(causal_conv(uf, w, cb))
    dbc = u32 @ p["x_proj"].float()
    dt_r, bm, cm = dbc.split([R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                # (Di, N)

    new_cache = cache
    if mode == "decode":
        decay = torch.exp(dt[:, 0, :, None] * A)              # (B, Di, N)
        inp = (dt[:, 0] * u32[:, 0])[..., None] * bm[:, 0, None, :]
        h = decay * cache["h"] + inp
        ys = torch.einsum("bdn,bn->bd", h, cm[:, 0])[:, None]
        if write is not None:
            keep = write.reshape(-1, 1, 1)
            h = torch.where(keep, h, cache["h"])
            conv_state = torch.where(keep, conv_state, cache["conv"])
        cache["h"].copy_(h)
        cache["conv"].copy_(conv_state)
    else:
        ys, h_last = scan_ops.mamba_scan(u32, dt, bm, cm, A)
        if mode == "prefill":
            # the conv state holds the last W-1 *pre-conv* inputs (a copy:
            # a view would keep the layer's whole input alive)
            new_cache = {"h": h_last, "conv": uf[:, -(W - 1):].clone()}
    y = (ys + p["D_skip"] * u32).to(cd)
    out = (y * F.silu(z)) @ p["out_proj"].to(cd)
    return out.to(x.dtype), new_cache


def _check_ported(cfg, entry):
    mixer, mlp = cfg.entry(entry)
    for part in (mixer, mlp):
        if part in NOT_PORTED:
            raise NotImplementedError(NOT_PORTED[part])
    return mixer, mlp


def block_init(cfg, entry, gen, device=None):
    mixer, mlp = _check_ported(cfg, entry)
    init = mamba_init if mixer == "mamba" else L.attn_init
    p = {"norm1": L.rmsnorm_init(cfg, device=device),
         "mixer": init(cfg, gen, device=device)}
    if mlp == "dense":
        p["norm2"] = L.rmsnorm_init(cfg, device=device)
        p["mlp"] = L.mlp_init(cfg, gen, d_ff=cfg.d_ff, device=device)
    return p


def block_cache(cfg, entry, batch, max_seq, device=None):
    """Zero cache for one block.  Local-attn caches are window-sized."""
    mixer, _ = _check_ported(cfg, entry)
    if mixer == "mamba":
        return mamba_cache(cfg, batch, device=device)
    if mixer == "attn_g":
        return L.attn_cache_shape(cfg, batch, max_seq, device=device)
    return L.attn_cache_shape(cfg, batch, min(max_seq, cfg.window),
                              device=device)


def block_apply(cfg, entry, p, x, *, mode, cache=None, pos=None,
                write=None):
    mixer, mlp = _check_ported(cfg, entry)
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "mamba":
        y, new_cache = mamba_apply(cfg, p["mixer"], h, mode=mode, cache=cache,
                                   write=write)
    else:
        window = cfg.window if mixer == "attn_l" else 0
        y, new_cache = L.attn_apply(cfg, p["mixer"], h, mode=mode,
                                    window=window, cache=cache, pos=pos,
                                    write=write)
    x = x + y
    if mlp == "dense":
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + L.mlp_apply(cfg, p["mlp"], h2)
    return x, new_cache
