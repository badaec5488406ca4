"""Ethernet tile: parse/strip on RX (VLAN-aware, paper §4.2), build on TX."""
from __future__ import annotations

import torch

from repro_torch.net import bytesops as B

ETH_HLEN = 14
VLAN_HLEN = 18
ETHERTYPE_IPV4 = 0x0800
ETHERTYPE_VLAN = 0x8100


def parse(payload, length):
    """Returns (stripped_payload, new_length, meta) — meta holds the MACs
    (hi32/lo16 words), the real ethertype, and the VLAN tag if present."""
    dst_hi = B.be32(payload, 0)
    dst_lo = B.be16(payload, 4)
    src_hi = B.be32(payload, 6)
    src_lo = B.be16(payload, 10)
    etype = B.be16(payload, 12)
    is_vlan = etype == ETHERTYPE_VLAN
    vlan_tci = torch.where(is_vlan, B.be16(payload, 14), 0)
    real_etype = torch.where(is_vlan, B.be16(payload, 16), etype)
    hlen = torch.where(is_vlan, VLAN_HLEN, ETH_HLEN).to(torch.int32)
    stripped = B.shift_left(payload, hlen)
    meta = {
        "eth_dst_hi": dst_hi, "eth_dst_lo": dst_lo,
        "eth_src_hi": src_hi, "eth_src_lo": src_lo,
        "ethertype": real_etype, "vlan_tci": vlan_tci,
    }
    return stripped, length - hlen, meta


def build(payload, length, meta):
    """Prepend an Ethernet header; TX swaps src/dst (reply semantics are the
    caller's job — these fields come straight from meta)."""
    out = B.shift_right(payload, ETH_HLEN)
    out = B.set_be32(out, 0, meta["eth_dst_hi"])
    out = B.set_be16(out, 4, meta["eth_dst_lo"])
    out = B.set_be32(out, 6, meta["eth_src_hi"])
    out = B.set_be16(out, 10, meta["eth_src_lo"])
    out = B.set_be16(out, 12, meta["ethertype"])
    return out, length + ETH_HLEN
