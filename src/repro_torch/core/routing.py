"""Node-table routing (paper §3.4, §4.2).

Each tile owns a small match table — the FPGA CAM — mapping a header field
(ethertype, ip_proto, udp/tcp port, rpc msg_type) to the next tile id.
Tables are *runtime tensors* held in tile state: the control plane can
rewrite them without touching the compiled pipeline.  Packets with no
matching entry are dropped (unsupported-traffic filtering, paper §4.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

DROP = -1          # next-hop id meaning "drop the packet"
TABLE_SLOTS = 16   # CAM entries per tile
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class RouteTable:
    """Fixed-capacity match table: (key -> next tile id)."""
    keys: torch.Tensor      # (TABLE_SLOTS,) int32; -1 = empty slot
    values: torch.Tensor    # (TABLE_SLOTS,) int32; tile id
    default: torch.Tensor   # () int32; next hop for wildcard (DROP = drop)

    def lookup(self, field: torch.Tensor) -> torch.Tensor:
        """field: (B,) int32 -> next tile id (B,) int32 (DROP if no match)."""
        hit = self.keys[None, :] == field[:, None]          # (B, S)
        any_hit = hit.any(dim=1)
        idx = torch.argmax(hit.to(torch.int32), dim=1)     # first hit
        val = self.values[idx]
        return torch.where(any_hit, val, self.default)

    def set_entry(self, slot: int, key: int, value: int) -> "RouteTable":
        """Runtime rewrite (control plane): returns a new table."""
        keys, values = self.keys.clone(), self.values.clone()
        keys[slot] = key
        values[slot] = value
        return RouteTable(keys=keys, values=values, default=self.default)


def make_table(entries: Sequence[Tuple[Optional[int], int]],
               default: int = DROP, device=None) -> RouteTable:
    keys = [-1] * TABLE_SLOTS
    vals = [DROP] * TABLE_SLOTS
    i = 0
    for key, value in entries:
        if key is None:
            default = value
            continue
        keys[i], vals[i] = int(key), int(value)
        i += 1
    return RouteTable(torch.tensor(keys, dtype=torch.int32, device=device),
                      torch.tensor(vals, dtype=torch.int32, device=device),
                      torch.tensor(default, dtype=torch.int32,
                                   device=device))


# ---------------------------------------------------------------------------
# flow hashing (4-tuple) for stateful load balancing — FNV-1a over the tuple.
# Unsigned 32-bit values are int64 masked to 32 bits.


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a < 2^32 held in int64: a full product of two
    32-bit values overflows int64, so c is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fnv1a(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """fields: list of (B,) ints holding 32-bit values -> (B,) hash."""
    h = None
    for f in fields:
        x = f.to(torch.int64) & M32
        if h is None:
            h = torch.full_like(x, 0x811C9DC5)
        for shift in (0, 8, 16, 24):
            byte = (x >> shift) & 0xFF
            h = _mul32(h ^ byte, 0x01000193)
    return h


def flow_hash(meta: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Standard 4-tuple hash: (src_ip, dst_ip, src_port, dst_port), with a
    murmur3-style avalanche finalizer so every output bit depends on every
    input bit (FNV-1a's multiply only diffuses upward)."""
    h = fnv1a([meta["src_ip"], meta["dst_ip"],
               meta["src_port"], meta["dst_port"]])
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h
