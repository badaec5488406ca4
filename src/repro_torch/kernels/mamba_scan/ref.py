"""The plain version of the Mamba-1 selective scan: a float32 loop over the
sequence in plain PyTorch.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) (x) B_t,   h_0 = 0
    y_t = sum_n h_t[:, n] * C_t[n]

It computes what the reference's oracle ``mamba_scan_ref`` computes (there
through ``linear_recurrence``'s chunked associative scan, here one timestep
at a time), and also returns the final state, which prefill keeps as the
session's cache.  It imports nothing from ``repro_torch.models``: the Mamba
block imports the op that imports this module.
"""
from __future__ import annotations

import torch


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, A: torch.Tensor):
    """u, dt: (B, S, D); bm, cm: (B, S, N); A: (D, N).  Returns
    (y (B, S, D), h_last (B, D, N)), both float32.  The decay and the input
    of every step are formed first, as the reference forms them; the loop
    carries only ``h = decay * h + inp``."""
    u32, dt32 = u.float(), dt.float()
    B, S, D = u.shape
    N = A.shape[-1]
    decay = torch.exp(dt32[..., None] * A.float())                # (B,S,D,N)
    inp = (dt32 * u32)[..., None] * bm.float()[:, :, None, :]     # (B,S,D,N)
    hs = torch.empty((B, S, D, N), dtype=torch.float32, device=u.device)
    h = torch.zeros((B, D, N), dtype=torch.float32, device=u.device)
    for t in range(S):
        h = torch.addcmul(inp[:, t], decay[:, t], h)
        hs[:, t] = h
    y = torch.einsum("bsdn,bsn->bsd", hs, cm.float())
    return y, h
