"""Plain PyTorch version of the RFC 1071 checksum kernel.

The same arithmetic as the reference's ``bytesops.checksum16`` /
``checksum16_with_pseudo``: big-endian 16-bit words of each row's valid
prefix summed mod 2^32, the pseudo-header partial sum added, three carry
folds, complement.  Unsigned 32-bit values are int64 masked to 32 bits.
The wrapper in ``ops.py`` uses it for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

M32 = 0xFFFFFFFF


def checksum16_ref(payload: torch.Tensor, start: int, length: torch.Tensor,
                   pseudo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, L) uint8, static ``start``, (B,) lengths [, (B,) partial sum]
    -> (B,) int64 complemented checksum in [0, 0xFFFF]."""
    B, L = payload.shape
    span = max(L - start, 0)
    seg = payload[:, start:start + span].to(torch.int64)
    idx = torch.arange(span, device=payload.device)
    seg = torch.where(idx[None, :] < length[:, None].to(torch.int64), seg, 0)
    if span % 2:
        seg = torch.nn.functional.pad(seg, (0, 1))
    words = (seg[:, 0::2] << 8) | seg[:, 1::2]
    total = words.sum(dim=1) & M32
    if pseudo is not None:
        total = (total + (pseudo.to(torch.int64) & M32)) & M32
    for _ in range(3):                       # fold carries
        total = (total & 0xFFFF) + (total >> 16)
    return (~total) & 0xFFFF
