"""The checksum wrapper: the hand-written CUDA kernel for tensors on the
card (``csrc/checksum.cu``), its plain version (``ref.py``) for tensors on
the CPU.  There is no fallback: a CUDA tensor launches the kernel or
raises.

``checksum16.launches`` counts kernel launches (plain-version calls do not
count), so a run can show that the packet path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.checksum.ref import checksum16_ref


def checksum16(payload: torch.Tensor, start: int, length: torch.Tensor,
               pseudo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ones-complement checksum of each row over ``[start, start +
    clamp(length, 0, L - start))``, plus the optional pseudo-header
    partial sum: (B, L) uint8, static int ``start``, (B,) lengths, (B,)
    partial sums -> (B,) int64 in [0, 0xFFFF]."""
    if payload.dim() != 2 or payload.dtype != torch.uint8:
        raise ValueError(f"payload must be (B, L) uint8, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if payload.device.type == "cpu":
        return checksum16_ref(payload, start, length, pseudo)
    if payload.device.type != "cuda":
        raise ValueError(f"no checksum kernel for device {payload.device}")
    from repro_torch import _build
    B, L = payload.shape
    if length.shape != (B,) or (pseudo is not None
                                and pseudo.shape != (B,)):
        raise ValueError("length and pseudo must be (B,)")
    if payload.stride(1) != 1:
        payload = payload.contiguous()
    length = length.to(device=payload.device,
                       dtype=torch.int32).contiguous()
    if pseudo is not None:
        pseudo = pseudo.to(device=payload.device,
                           dtype=torch.int64).contiguous()
    out = torch.empty((B,), dtype=torch.int64, device=payload.device)
    err = _build.load().beehive_checksum16(
        payload.data_ptr(), B, L, payload.stride(0), int(start),
        length.data_ptr(), None if pseudo is None else pseudo.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(payload.device).cuda_stream)
    _build.check(err, "checksum16")
    checksum16.launches += 1
    return out


checksum16.launches = 0
