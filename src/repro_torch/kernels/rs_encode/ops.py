"""The Reed-Solomon wrapper: the hand-written CUDA kernel for tensors on
the card (``csrc/rs_encode.cu``), its plain version (``ref.py``) for
tensors on the CPU.  There is no fallback: a CUDA tensor launches the
kernel or raises.

``encode_blocks.launches`` counts kernel launches (plain-version calls do
not count).  Both public functions launch through ``encode_blocks``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.rs_encode import gf
from repro_torch.kernels.rs_encode.ref import rs_encode_blocks_ref


@functools.lru_cache(maxsize=None)
def mats(k: int, p: int):
    """(generator (p, k), bit-plane matrix (p, k, 8)) as uint8 numpy."""
    gm = gf.generator_matrix(k, p)
    return gm, np.ascontiguousarray(gf.bitplane_matrix(gm))


def encode_blocks(blocks: torch.Tensor, k: int = 8, p: int = 2
                  ) -> torch.Tensor:
    """blocks: (B, k*S) uint8 request payloads -> (B, p*S) parity: the
    paper's 4 KiB-in / 1 KiB-out RS(8,2) app semantics, computed in the
    request layout (no transposes).  ``blocks`` may be a row-strided view
    (e.g. the first k*S columns of a wider body)."""
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"blocks must be (B, k*S) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    B, total = blocks.shape
    if total % k:
        raise ValueError(f"row width {total} is not a multiple of k={k}")
    S = total // k
    _, bp = mats(k, p)
    if blocks.device.type == "cpu":
        return rs_encode_blocks_ref(blocks, bp)
    if blocks.device.type != "cuda":
        raise ValueError(f"no RS kernel for device {blocks.device}")
    from repro_torch import _build
    if blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    if S % 4 or blocks.stride(0) % 4 or blocks.data_ptr() % 4:
        raise ValueError(f"the RS kernel needs 4-byte aligned shards and "
                         f"rows: S={S}, row stride {blocks.stride(0)}")
    out = torch.empty((B, p * S), dtype=torch.uint8, device=blocks.device)
    err = _build.load().beehive_rs_encode(
        blocks.data_ptr(), B, S, blocks.stride(0), k, p,
        bp.ctypes.data, out.data_ptr(), out.stride(0),
        torch.cuda.current_stream(blocks.device).cuda_stream)
    _build.check(err, "rs_encode")
    encode_blocks.launches += 1
    return out


encode_blocks.launches = 0


def rs_encode(data: torch.Tensor, k: int = 8, p: int = 2) -> torch.Tensor:
    """data: (k, N) uint8 -> parity (p, N) uint8 for RS(k+p, k): the TPU
    kernel's layout, which is the request layout with one row."""
    if data.shape[0] != k:
        raise ValueError(f"data has {data.shape[0]} shards, expected {k}")
    N = data.shape[1]
    return encode_blocks(data.contiguous().reshape(1, k * N), k, p
                         ).reshape(p, N)
