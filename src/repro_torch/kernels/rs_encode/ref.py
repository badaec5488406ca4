"""Plain versions of the Reed-Solomon encoder.

``rs_encode_blocks_ref`` is the plain PyTorch version of the CUDA kernel:
the same bit-plane arithmetic on the same request layout (B, k*S) ->
(B, p*S).  The wrapper in ``ops.py`` uses it for tensors on the CPU.
``rs_encode_np`` is the numpy oracle (log/antilog tables), independent of
the bit-plane formulation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.rs_encode import gf


def rs_encode_blocks_ref(blocks: torch.Tensor, bitplanes: np.ndarray
                         ) -> torch.Tensor:
    """blocks: (B, k*S) uint8, bitplanes: (p, k, 8) uint8 numpy ->
    (B, p*S) uint8 parity, parity_j = XOR_i XOR_b bit_b(data_i) *
    bitplanes[j, i, b]."""
    p, k, _ = bitplanes.shape
    B, total = blocks.shape
    S = total // k
    data = blocks.reshape(B, k, S)
    out = torch.zeros((B, p, S), dtype=torch.uint8, device=blocks.device)
    for i in range(k):
        x = data[:, i]
        for b in range(8):
            bit = (x >> b) & 1
            for j in range(p):
                out[:, j] ^= bit * int(bitplanes[j, i, b])
    return out.reshape(B, p * S)


def rs_encode_np(data: np.ndarray, gm: np.ndarray) -> np.ndarray:
    """data: (k, N) uint8, gm: (p, k) -> (p, N). Classic table method."""
    p, k = gm.shape
    out = np.zeros((p, data.shape[1]), np.uint8)
    for j in range(p):
        acc = np.zeros(data.shape[1], np.uint8)
        for i in range(k):
            acc ^= gf.gf_mul_vec(data[i], int(gm[j, i]))
        out[j] = acc
    return out
