"""GF(256) arithmetic (poly 0x11D) + Reed-Solomon generator matrices.

Host-side (numpy) table construction; the device kernel uses the
*bit-plane* representation: multiply-by-constant c over GF(2^8) is linear
over GF(2), so y = XOR_b [ ((x >> b) & 1) * (c * 2^b) ] — eight AND/XOR
vector ops per coefficient, no gathers.  This is the TPU-native
re-formulation of the FPGA's LUT-based GF multipliers (DESIGN.md).
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


def gf_inv(a: int) -> int:
    return int(EXP[255 - LOG[a]])


def gf_mul_vec(a: np.ndarray, b: int) -> np.ndarray:
    """Vectorized multiply-by-constant via log tables (numpy oracle)."""
    if b == 0:
        return np.zeros_like(a)
    out = EXP[LOG[a] + LOG[b]]
    out[a == 0] = 0
    return out.astype(np.uint8)


def generator_matrix(k: int, p: int) -> np.ndarray:
    """Vandermonde-derived parity rows (p, k), systematic RS(k+p, k).
    Row j, col i = alpha^(j*i) — classic Backblaze-style construction is a
    Cauchy/Vandermonde product; a plain Vandermonde on distinct points is
    MDS for these small sizes."""
    gm = np.zeros((p, k), np.uint8)
    for j in range(p):
        for i in range(k):
            gm[j, i] = gf_pow(2, (j + 1) * i) if True else 0
    return gm


def bitplane_matrix(gm: np.ndarray) -> np.ndarray:
    """(p, k) coefficients -> (p, k, 8) uint8: entry [j,i,b] = gm[j,i]*2^b
    over GF(256) — the byte contributed by input bit b."""
    p, k = gm.shape
    out = np.zeros((p, k, 8), np.uint8)
    for j in range(p):
        for i in range(k):
            for b in range(8):
                out[j, i, b] = gf_mul(int(gm[j, i]), 1 << b)
    return out
