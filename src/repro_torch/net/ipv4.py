"""IPv4 tile: parse + checksum verify on RX, build + checksum on TX.
No fragmentation support — internal datacenter services (paper §4.2).
Both checksums run on the checksum kernel (``kernels/checksum``)."""
from __future__ import annotations

import torch

from repro_torch.net import bytesops as B
from repro_torch.obs import reasons as R

IP_HLEN = 20          # options unsupported (ihl=5), like the paper's tile
PROTO_TCP = 6
PROTO_UDP = 17


def parse(payload, length):
    """Returns (stripped, new_length, meta, ok).  ok=False -> drop."""
    return parse_ex(payload, length)[:4]


def parse_ex(payload, length):
    """`parse` plus a per-packet drop-reason code (repro_torch.obs.reasons):
    why ok is False, first failing check wins.  0 = not dropped."""
    ver_ihl = B.u8(payload, 0)
    version = ver_ihl >> 4
    ihl = (ver_ihl & 0xF).to(torch.int32) * 4
    ecn = B.u8(payload, 1) & 0x3          # RFC 3168 ECN field (3 = CE)
    total_len = B.be16(payload, 2)
    ttl = B.u8(payload, 8)
    proto = B.u8(payload, 9)
    src_ip = B.be32(payload, 12)
    dst_ip = B.be32(payload, 16)
    csum = B.checksum16(payload, 0, ihl)   # over header; valid iff == 0
    ok_ver = version == 4
    ok_csum = csum == 0
    ok_ttl = ttl > 0
    ok_len = total_len.to(torch.int32) <= length
    ok = ok_ver & ok_csum & ok_ttl & ok_len
    reason = torch.where(
        ~ok_ver, R.IP_VERSION,
        torch.where(~ok_csum, R.IP_CSUM,
                    torch.where(~ok_ttl, R.IP_TTL,
                                torch.where(~ok_len, R.IP_LEN, R.NONE))))
    stripped = B.shift_left(payload, ihl)
    meta = {"ip_proto": proto, "src_ip": src_ip, "dst_ip": dst_ip,
            "ip_ttl": ttl, "ip_total_len": total_len, "ip_ecn": ecn}
    return (stripped, total_len.to(torch.int32) - ihl, meta, ok,
            reason.to(torch.int32))


def build(payload, length, meta, ident=None):
    """Prepend a 20-byte IPv4 header with computed checksum."""
    out = B.shift_right(payload, IP_HLEN)
    total = (length + IP_HLEN).to(torch.int64) & B.M32
    z = torch.zeros_like(total)
    out = B.set_u8(out, 0, 0x45)                             # v4, ihl=5
    out = B.set_u8(out, 1, 0)                                # dscp
    out = B.set_be16(out, 2, total)
    out = B.set_be16(out, 4, ident if ident is not None else z)  # id
    out = B.set_be16(out, 6, torch.full_like(total, 0x4000))  # DF
    out = B.set_u8(out, 8, 64)                               # ttl
    out = B.set_u8(out, 9, meta["ip_proto"])
    out = B.set_be16(out, 10, z)                             # csum slot
    out = B.set_be32(out, 12, meta["src_ip"])
    out = B.set_be32(out, 16, meta["dst_ip"])
    csum = B.checksum16(out, 0, torch.full_like(length, IP_HLEN,
                                                dtype=torch.int32))
    out = B.set_be16(out, 10, csum)
    return out, length + IP_HLEN
