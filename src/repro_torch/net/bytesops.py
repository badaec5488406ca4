"""Vectorized byte-level packet operations on (B, L) uint8 tensors.

Payloads are (B, L) uint8 tensors with per-packet valid lengths.  Field
reads return int64 tensors holding unsigned 32-bit values (the reference's
uint32, masked to 32 bits).  The ``set_*`` and ``write_bytes`` writers
update the tensor they are given **in place** and return it: every caller
in the port writes into a tensor it has just built with ``shift_right``.
The two checksum functions run the hand-written CUDA kernel on the card
and its plain version on the CPU (``kernels/checksum``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels.checksum import ops as csum_ops

M32 = 0xFFFFFFFF
Offset = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# field reads (big-endian network order)


def _take(payload: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """payload[b, off[b]] as int64, with the reference's gather semantics
    (``jnp.take_along_axis``): a negative offset counts from the end, an
    offset still out of range reads the uint8 fill value 255."""
    L = payload.shape[1]
    off = off.to(torch.int64)
    off = torch.where(off < 0, off + L, off)
    inside = (off >= 0) & (off < L)
    got = torch.gather(payload, 1, off.clamp(0, L - 1)[:, None])[:, 0]
    return torch.where(inside, got.to(torch.int64), 255)


def u8(payload: torch.Tensor, off: Offset) -> torch.Tensor:
    if isinstance(off, int):
        return payload[:, off].to(torch.int64)
    return _take(payload, off)


def be16(payload: torch.Tensor, off: Offset) -> torch.Tensor:
    """(B, L) uint8, static or (B,) offset -> (B,) int64."""
    if isinstance(off, int):
        return (u8(payload, off) << 8) | u8(payload, off + 1)
    return (_take(payload, off) << 8) | _take(payload, off + 1)


def be32(payload: torch.Tensor, off: Offset) -> torch.Tensor:
    if isinstance(off, int):
        b = [u8(payload, off + i) for i in range(4)]
    else:
        b = [_take(payload, off + i) for i in range(4)]
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


# ---------------------------------------------------------------------------
# field writes (in place)


def _u8(val, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(val, torch.Tensor):
        return torch.full((like.shape[0],), int(val) & 0xFF,
                          dtype=torch.uint8, device=like.device)
    return (val.to(torch.int64) & 0xFF).to(torch.uint8)


def set_u8(payload: torch.Tensor, off: int, val) -> torch.Tensor:
    payload[:, off] = _u8(val, payload)
    return payload


def set_be16(payload: torch.Tensor, off: int, val) -> torch.Tensor:
    v = val.to(torch.int64) & M32
    payload[:, off] = _u8(v >> 8, payload)
    payload[:, off + 1] = _u8(v, payload)
    return payload


def set_be32(payload: torch.Tensor, off: int, val) -> torch.Tensor:
    v = val.to(torch.int64) & M32
    for i, sh in enumerate((24, 16, 8, 0)):
        payload[:, off + i] = _u8(v >> sh, payload)
    return payload


def write_bytes(payload: torch.Tensor, off: int,
                data: torch.Tensor) -> torch.Tensor:
    """Write (B, n) bytes at a static offset.  Like the reference's
    ``dynamic_update_slice``, the offset is clamped so the write fits."""
    n = data.shape[1]
    L = payload.shape[1]
    off = min(max(off, 0), L - n)
    payload[:, off:off + n] = data.to(torch.uint8)
    return payload


# ---------------------------------------------------------------------------
# header strip / prepend (data realignment)


def shift_left(payload: torch.Tensor, n: Offset, mask=None) -> torch.Tensor:
    """Strip n leading bytes per packet (n: static int or (B,) int).  As in
    the reference, the source index is clipped to [0, L-1], so the tail
    repeats the last byte of the row."""
    B, L = payload.shape
    if isinstance(n, int):
        out = torch.empty_like(payload)
        if n >= 0:
            src = min(n, L - 1)
            out[:, :L - src] = payload[:, src:]
            out[:, L - src:] = payload[:, L - 1:L]
        else:
            k = min(-n, L)
            out[:, :k] = payload[:, :1]
            out[:, k:] = payload[:, :L - k]
    else:
        idx = torch.arange(L, device=payload.device)[None, :]
        src = (idx + n.to(torch.int64)[:, None]).clamp(0, L - 1)
        out = torch.gather(payload, 1, src)
    if mask is not None:
        out = torch.where(mask[:, None], out, payload)
    return out


def shift_right(payload: torch.Tensor, n: Offset, mask=None) -> torch.Tensor:
    """Make room for an n-byte header (contents shifted toward the tail,
    zeros in front)."""
    B, L = payload.shape
    if isinstance(n, int):
        out = torch.zeros_like(payload)
        if n >= 0:
            k = min(n, L)
            out[:, k:] = payload[:, :L - k]
        else:
            src = min(-n, L - 1)
            out[:, :L - src] = payload[:, src:]
            out[:, L - src:] = payload[:, L - 1:L]
    else:
        idx = torch.arange(L, device=payload.device)[None, :]
        src = idx - n.to(torch.int64)[:, None]
        got = torch.gather(payload, 1, src.clamp(0, L - 1))
        out = torch.where(src >= 0, got, 0).to(torch.uint8)
    if mask is not None:
        out = torch.where(mask[:, None], out, payload)
    return out


# ---------------------------------------------------------------------------
# RFC 1071 internet checksum (kernel 1 on the card)


def checksum16(payload: torch.Tensor, start: int,
               length: torch.Tensor) -> torch.Tensor:
    """Ones-complement 16-bit checksum over [start, start+length) per
    packet.  start: static int; length: (B,) int.  Returns (B,) int64
    (already complemented, network order)."""
    return csum_ops.checksum16(payload, start, length)


def pseudo_header_sum(src_ip, dst_ip, proto, tcp_len) -> torch.Tensor:
    """IPv4 pseudo-header contribution for UDP/TCP checksums (unfolded)."""
    s = (src_ip >> 16) + (src_ip & 0xFFFF)
    s = s + (dst_ip >> 16) + (dst_ip & 0xFFFF)
    s = s + (proto.to(torch.int64) & M32) + (tcp_len.to(torch.int64) & M32)
    return s & M32


def checksum16_with_pseudo(payload: torch.Tensor, start: int,
                           length: torch.Tensor,
                           pseudo: torch.Tensor) -> torch.Tensor:
    """Checksum including a pseudo-header partial sum."""
    return csum_ops.checksum16(payload, start, length, pseudo)
