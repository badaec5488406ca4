"""Minimal RPC framing used by the app tiles (echo / RS serving).

Frame layout (big-endian):
  [magic u16 = 0xBEE5][msg_type u8][req_id u32][payload_len u16][payload]

Unmodified clients build these frames over standard UDP sockets
(frames.py provides the host-side builders).
"""
from __future__ import annotations

import torch

from repro_torch.net import bytesops as B
from repro_torch.obs import reasons as R

MAGIC = 0xBEE5
HLEN = 9

MSG_ECHO = 1
MSG_RS_ENCODE = 2
MSG_VR_PREPARE = 3
MSG_VR_COMMIT = 4
MSG_LM_GENERATE = 5
MSG_CTRL = 6
MSG_LM_RELEASE = 7
MSG_ALERT = 8          # watchdog -> collector: SLO threshold edge
MSG_POSTCARD = 9       # int_mirror -> collector: per-hop telemetry


def parse(payload, length):
    return parse_ex(payload, length)[:4]


def parse_ex(payload, length):
    """`parse` plus a per-packet drop-reason code (repro_torch.obs.reasons)."""
    magic = B.be16(payload, 0)
    msg_type = B.u8(payload, 2)
    req_id = B.be32(payload, 3)
    plen = B.be16(payload, 7)
    ok_magic = magic == MAGIC
    ok_len = plen.to(torch.int32) + HLEN <= length
    ok = ok_magic & ok_len
    reason = torch.where(~ok_magic, R.RPC_MAGIC,
                         torch.where(~ok_len, R.RPC_LEN, R.NONE))
    body = B.shift_left(payload, HLEN)
    return (body, plen.to(torch.int32),
            {"msg_type": msg_type, "req_id": req_id}, ok,
            reason.to(torch.int32))


def build(payload, length, msg_type, req_id):
    out = B.shift_right(payload, HLEN)
    out = B.set_be16(out, 0, torch.full((payload.shape[0],), MAGIC,
                                        dtype=torch.int64,
                                        device=payload.device))
    out = B.set_u8(out, 2, msg_type)
    out = B.set_be32(out, 3, req_id)
    out = B.set_be16(out, 7, length)
    return out, length + HLEN


def np_frame(msg_type: int, req_id: int, payload: bytes) -> bytes:
    import struct
    return struct.pack("!HBIH", MAGIC, msg_type, req_id, len(payload)) + payload
