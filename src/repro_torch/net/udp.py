"""UDP tile: parse + (optional) checksum verify on RX, build on TX.
Both checksums run on the checksum kernel (``kernels/checksum``), which
also adds the IPv4 pseudo-header term."""
from __future__ import annotations

import torch

from repro_torch.net import bytesops as B
from repro_torch.net.ipv4 import PROTO_UDP
from repro_torch.obs import reasons as R

UDP_HLEN = 8


def parse(payload, length, meta):
    """Returns (stripped, new_length, meta', ok)."""
    return parse_ex(payload, length, meta)[:4]


def parse_ex(payload, length, meta):
    """`parse` plus a per-packet drop-reason code (repro_torch.obs.reasons):
    the runt check is attributed first (it poisons everything after),
    then the length-vs-IP check, then the checksum."""
    src_port = B.be16(payload, 0)
    dst_port = B.be16(payload, 2)
    udp_len = B.be16(payload, 4)
    csum = B.be16(payload, 6)
    pseudo = B.pseudo_header_sum(meta["src_ip"], meta["dst_ip"],
                                 torch.full_like(meta["src_ip"], PROTO_UDP),
                                 udp_len)
    full = B.checksum16_with_pseudo(payload, 0, udp_len.to(torch.int32),
                                    pseudo)
    ok_csum = (csum == 0) | (full == 0)    # csum 0 = disabled (RFC 768)
    ok_len = udp_len.to(torch.int32) <= length
    # runt header: udp_len < 8 would yield a negative payload length that
    # poisons every downstream length computation — reject AND clamp
    ok_runt = udp_len.to(torch.int32) >= UDP_HLEN
    ok = ok_csum & ok_len & ok_runt
    reason = torch.where(
        ~ok_runt, R.RUNT_UDP,
        torch.where(~ok_len, R.UDP_LEN,
                    torch.where(~ok_csum, R.UDP_CSUM, R.NONE)))
    stripped = B.shift_left(payload, UDP_HLEN)
    m = dict(meta)
    m.update({"src_port": src_port, "dst_port": dst_port,
              "udp_len": udp_len})
    plen = torch.clamp(udp_len.to(torch.int32) - UDP_HLEN, min=0)
    return stripped, plen, m, ok, reason.to(torch.int32)


def build(payload, length, meta, with_checksum: bool = True):
    """Prepend a UDP header; meta ports are already reply-oriented."""
    out = B.shift_right(payload, UDP_HLEN)
    ulen = (length + UDP_HLEN).to(torch.int64) & B.M32
    out = B.set_be16(out, 0, meta["src_port"])
    out = B.set_be16(out, 2, meta["dst_port"])
    out = B.set_be16(out, 4, ulen)
    out = B.set_be16(out, 6, torch.zeros_like(ulen))
    if with_checksum:
        pseudo = B.pseudo_header_sum(meta["src_ip"], meta["dst_ip"],
                                     torch.full_like(meta["src_ip"],
                                                     PROTO_UDP),
                                     ulen)
        csum = B.checksum16_with_pseudo(out, 0, ulen.to(torch.int32),
                                        pseudo)
        csum = torch.where(csum == 0, 0xFFFF, csum)
        out = B.set_be16(out, 6, csum)
    return out, length + UDP_HLEN
