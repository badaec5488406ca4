"""Per-port token-bucket rate limiting, applied at the dispatch tile.

A small fixed-capacity table (same shape discipline as the routing CAMs:
runtime tensors, rewritable by the control plane) maps an L4 destination
port to a token bucket.  ``apply`` runs once per batch inside the
``udp_rx`` tile: buckets refill by ``rate`` tokens (packets) per batch up
to ``burst``, and packets beyond a port's available tokens are dropped in
arrival order.  Ports with no entry are unlimited; a cleared slot has port
-1 and matches nothing.
"""
from __future__ import annotations

import torch

I32 = torch.int32

SLOTS = 8


def init(slots: int = SLOTS, device=None):
    return {
        "ports": torch.full((slots,), -1, dtype=I32, device=device),
        "rate": torch.zeros((slots,), dtype=I32, device=device),
        "burst": torch.zeros((slots,), dtype=I32, device=device),
        "tokens": torch.zeros((slots,), dtype=I32, device=device),
    }


def set_slot(rt, slot: int, port: int, rate: int, burst=None):
    """Install (or rewrite) one bucket; the bucket starts full."""
    burst = rate if burst is None else burst
    rt = {k: v.clone() for k, v in rt.items()}
    rt["ports"][slot] = port
    rt["rate"][slot] = rate
    rt["burst"][slot] = burst
    rt["tokens"][slot] = burst
    return rt


def clear_slot(rt, slot: int):
    return set_slot(rt, slot, -1, 0, 0)


def apply(rt, dst_port, arrived):
    """One batch step.  dst_port: (B,) int, arrived: (B,) bool.
    Returns (rt', ok) — ok[b] False means packet b exceeded its port's
    bucket and must be dropped."""
    tokens = torch.minimum(rt["tokens"] + rt["rate"], rt["burst"])
    port = dst_port.to(I32)
    live = rt["ports"] >= 0
    match = (port[:, None] == rt["ports"][None, :]) & live[None, :] \
        & arrived[:, None]                                   # (B, S)
    cum = torch.cumsum(match.to(I32), dim=0)                 # arrival order
    allowed = cum <= tokens[None, :]
    ok = (~match | allowed).all(dim=1)
    consumed = torch.minimum(match.sum(dim=0, dtype=I32), tokens)
    rt = dict(rt)
    rt["tokens"] = tokens - consumed
    return rt, ok
