"""The plain version of flash attention: dense masked softmax attention,
the reference's ``attention_ref`` oracle in PyTorch (same masks, the same
``-1e30`` for masked scores, the same ``1e-30`` floor on the denominator,
everything in float32)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, S, hd); k, v: (BKV, S, hd) with BH = BKV * G (query head
    ``b`` reads kv head ``b // G``).  Returns (BH, S, hd) in q's dtype."""
    BH, S, hd = q.shape
    G = BH // k.shape[0]
    kk = k.repeat_interleave(G, dim=0)
    vv = v.repeat_interleave(G, dim=0)
    s = torch.einsum("bsh,bth->bst", q.float(), kk.float()) / math.sqrt(hd)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bst,bth->bsh", w, vv.float()).to(q.dtype)


def attention_model_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """:func:`attention_ref` in the model layout, as the reference's
    ``ops.flash_attention(use_pallas=False)`` maps it: q (B, S, KV, G, hd),
    k/v (B, S, KV, hd) -> (B, S, KV, G, hd)."""
    B, S, KV, G, hd = q.shape
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, hd)
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    of = attention_ref(qf, kf, vf, causal=causal, window=window)
    return of.reshape(B, KV, G, S, hd).permute(0, 3, 1, 2, 4)
