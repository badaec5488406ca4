"""The port's two kernels: their plain PyTorch versions against the
reference's Pallas kernels (interpret mode) and oracles, bit for bit, also
at the edges of the CUDA kernels' designs, and — on a machine with a GPU —
the CUDA kernels against the plain versions.

The CUDA tests carry the ``gpu`` marker and decide inside a fixture whether
there is a card, skipping with the reason when there is none (the kernels
are CUDA C++: they have no interpret mode).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum.kernel import checksum_pallas
from repro.kernels.checksum.ref import checksum_ref as j_checksum_ref
from repro.kernels.rs_encode import gf as jgf
from repro.kernels.rs_encode import ops as j_rs_ops
from repro.kernels.rs_encode.kernel import rs_encode_pallas
from repro.kernels.rs_encode.ref import rs_encode_np as j_rs_encode_np
from repro.net import bytesops as JB
from repro_torch.kernels.checksum import ops as csum_ops
from repro_torch.kernels.checksum.ref import checksum16_ref
from repro_torch.kernels.rs_encode import gf
from repro_torch.kernels.rs_encode import ops as rs_ops
from repro_torch.kernels.rs_encode.ref import (rs_encode_blocks_ref,
                                               rs_encode_np)

RS_SWEEP = [(8, 2), (4, 2), (10, 4), (6, 3)]
# the checksum kernel's boundaries (csrc/checksum.cu: a warp a row, one
# 16-byte load a lane a round, 9 rounds a pass): a load, a round, a pass,
# two passes, counted from the row's first 16-byte aligned byte, which is
# 0, 2, 12, 13 or 15 bytes in on the rows and starts below; and prefixes
# that end inside a 16-byte load
CSUM_BOUNDS = (16, 16 * 32, 16 * 32 * 9, 2 * 16 * 32 * 9)
CSUM_EDGE_LENGTHS = sorted(
    {b + d + h for b in CSUM_BOUNDS for d in (-1, 0, 1)
     for h in (0, 2, 12, 13, 15)}
    | {16 * m + r for m in (1, 257) for r in (1, 4, 15)})
# the RS kernel's edges (csrc/rs_encode.cu: 8 bytes of a shard column a
# thread, 128 threads a block): (rows, first column, end column, k, p) of
# a view of (rows, 4160) bodies
RS_EDGES = [(1, 0, 4096, 8, 2), (3, 0, 4096, 8, 2), (513, 0, 4096, 8, 2),
            (5, 4, 4100, 8, 2), (3, 0, 4000, 8, 2), (3, 0, 4000, 10, 4),
            (3, 4, 4004, 10, 4), (1, 0, 3072, 6, 3)]


def csum_edge_batch(seed, rows, width, offset):
    """(rows, width) uint8 rows `offset` bytes into 16-byte aligned rows of
    a wider array, the edge lengths cycled over the rows, pseudo terms."""
    rng = np.random.default_rng(seed)
    stride = (width + offset + 15) // 16 * 16
    data = rng.integers(0, 256, (rows, stride), dtype=np.uint8)
    length = np.resize(np.asarray(CSUM_EDGE_LENGTHS, np.int32), rows)
    pseudo = rng.integers(0, 2 ** 20, rows).astype(np.int64)
    return data, length, pseudo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "interpret mode (python3 chip_smoke.py runs them)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# checksum: plain version vs the Pallas kernel and the reference oracle


@pytest.mark.parametrize("B,L", [(1, 64), (7, 128), (9, 1500)])
def test_checksum_plain_vs_pallas_and_ref(B, L):
    rng = np.random.default_rng(B * L)
    data = rng.integers(0, 256, (B, L), dtype=np.uint8)
    length = rng.integers(0, L + 1, (B,)).astype(np.int32)
    length[0] = 0
    want = np.asarray(checksum_pallas(jnp.asarray(data), jnp.asarray(length)))
    np.testing.assert_array_equal(
        want, np.asarray(j_checksum_ref(jnp.asarray(data),
                                        jnp.asarray(length))))
    td, tl = torch.from_numpy(data), torch.from_numpy(length)
    for got in (csum_ops.checksum16(td, 0, tl), checksum16_ref(td, 0, tl)):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_checksum_wrapper_on_cpu_counts_no_launch_and_refuses_others():
    before = csum_ops.checksum16.launches
    data = torch.zeros((2, 8), dtype=torch.uint8)
    csum_ops.checksum16(data, 0, torch.tensor([8, 3], dtype=torch.int32))
    assert csum_ops.checksum16.launches == before
    with pytest.raises(ValueError):
        csum_ops.checksum16(torch.zeros((2, 8), dtype=torch.uint8,
                                        device="meta"), 0,
                            torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError):
        csum_ops.checksum16(torch.zeros((2, 8), dtype=torch.int32), 0,
                            torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize("rows,width,offset", [(1, 4160, 0), (513, 4160, 0),
                                              (41, 9316, 0), (41, 9316, 3)])
def test_checksum_plain_at_kernel_edges(rows, width, offset):
    """The plain version (and the wrapper on the CPU) against the
    reference's checksum16 / checksum16_with_pseudo at the CUDA kernel's
    boundaries, on aligned rows and on rows 3 bytes off."""
    data, length, pseudo = csum_edge_batch(rows + width + offset, rows,
                                           width, offset)
    view = torch.from_numpy(data)[:, offset:offset + width]
    jview = jnp.asarray(data[:, offset:offset + width])
    tl, jl = torch.from_numpy(length), jnp.asarray(length)
    for start in (0, 1, 14):
        want = np.asarray(JB.checksum16(jview, start, jl)).astype(np.int64)
        want_ps = np.asarray(JB.checksum16_with_pseudo(
            jview, start, jl, jnp.asarray(pseudo.astype(np.uint32))))
        for got in (csum_ops.checksum16(view, start, tl),
                    checksum16_ref(view, start, tl)):
            np.testing.assert_array_equal(got.numpy(), want)
        got = csum_ops.checksum16(view, start, tl, torch.from_numpy(pseudo))
        np.testing.assert_array_equal(got.numpy(), want_ps.astype(np.int64))


# ---------------------------------------------------------------------------
# RS: tables, plain version vs the Pallas kernel and the numpy oracle


@pytest.mark.parametrize("k,p", RS_SWEEP)
def test_gf_tables_equal_reference(k, p):
    np.testing.assert_array_equal(gf.EXP, jgf.EXP)
    np.testing.assert_array_equal(gf.LOG, jgf.LOG)
    gm = gf.generator_matrix(k, p)
    np.testing.assert_array_equal(gm, jgf.generator_matrix(k, p))
    np.testing.assert_array_equal(gf.bitplane_matrix(gm),
                                  jgf.bitplane_matrix(gm))
    np.testing.assert_array_equal(rs_ops.mats(k, p)[1],
                                  j_rs_ops._mats(k, p)[1])


def test_rs_plain_vs_pallas_interpret():
    rng = np.random.default_rng(82)
    data = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    gm = jgf.generator_matrix(8, 2)
    want = np.asarray(rs_encode_pallas(
        jnp.asarray(data), jnp.asarray(jgf.bitplane_matrix(gm))))
    got = rs_ops.rs_encode(torch.from_numpy(data), 8, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,p", RS_SWEEP)
@pytest.mark.parametrize("n", [4096, 16384])
def test_rs_plain_vs_numpy_oracle(k, p, n):
    rng = np.random.default_rng(k * 100 + p)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    gm = gf.generator_matrix(k, p)
    want = j_rs_encode_np(data, gm)
    np.testing.assert_array_equal(rs_encode_np(data, gm), want)
    np.testing.assert_array_equal(
        rs_ops.rs_encode(torch.from_numpy(data), k, p).numpy(), want)


def test_encode_blocks_request_layout_matches_reference():
    """(B, k*S) requests, here a row-strided view of wider bodies, against
    the reference's transpose-encode-transpose."""
    rng = np.random.default_rng(5)
    body = rng.integers(0, 256, (6, 4160), dtype=np.uint8)
    want = np.asarray(j_rs_ops.encode_blocks(jnp.asarray(body[:, :4096]),
                                             use_pallas=False))
    before = rs_ops.encode_blocks.launches
    got = rs_ops.encode_blocks(torch.from_numpy(body)[:, :4096])
    assert rs_ops.encode_blocks.launches == before
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        rs_ops.encode_blocks(torch.zeros((2, 4095), dtype=torch.uint8))


@pytest.mark.parametrize("rows,lo,hi,k,p", RS_EDGES)
def test_rs_plain_at_kernel_edges(rows, lo, hi, k, p):
    """The wrapper on the CPU (the plain version) against the reference's
    encode_blocks on the views the CUDA kernel's edges take: one row, rows
    that leave a block partly empty, a view 4 bytes off 16-byte alignment,
    shards of 500 and 400 bytes."""
    rng = np.random.default_rng(rows * 1000 + lo + k)
    body = rng.integers(0, 256, (rows, 4160), dtype=np.uint8)
    want = np.asarray(j_rs_ops.encode_blocks(jnp.asarray(body[:, lo:hi]), k,
                                             p, use_pallas=False))
    got = rs_ops.encode_blocks(torch.from_numpy(body)[:, lo:hi], k, p)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (GPU only)


@pytest.mark.gpu
def test_checksum_kernel_on_card(cuda):
    rng = np.random.default_rng(0)
    for width in (4160, 4161, 64, 1):
        data = torch.from_numpy(rng.integers(0, 256, (33, width),
                                             dtype=np.uint8)).to(cuda)
        length = torch.from_numpy(np.concatenate(
            [[0, 1, width, width + 5, -1],
             rng.integers(0, width + 1, 28)]).astype(np.int32)).to(cuda)
        pseudo = torch.from_numpy(rng.integers(0, 1 << 20, 33)).to(cuda)
        for start in (0, 1, 14):
            for ps in (None, pseudo):
                before = csum_ops.checksum16.launches
                got = csum_ops.checksum16(data, start, length, ps)
                assert csum_ops.checksum16.launches == before + 1
                assert torch.equal(got, checksum16_ref(data, start, length,
                                                       ps))
    # the design's edges: rows 1 and 513, its boundaries, aligned rows and
    # rows 3 bytes off
    for rows, width, offset in ((1, 4160, 0), (513, 4160, 0), (513, 4160, 3),
                                (41, 9316, 0), (41, 9316, 3)):
        data, length, pseudo = csum_edge_batch(rows, rows, width, offset)
        view = torch.from_numpy(data).to(cuda)[:, offset:offset + width]
        tl = torch.from_numpy(length).to(cuda)
        tp = torch.from_numpy(pseudo).to(cuda)
        for start in (0, 1, 14):
            for ps in (None, tp):
                assert torch.equal(csum_ops.checksum16(view, start, tl, ps),
                                   checksum16_ref(view, start, tl, ps))


@pytest.mark.gpu
@pytest.mark.parametrize("k,p", RS_SWEEP)
def test_rs_kernel_on_card(cuda, k, p):
    rng = np.random.default_rng(k + p)
    data = rng.integers(0, 256, (k, 16384), dtype=np.uint8)
    got = rs_ops.rs_encode(torch.from_numpy(data).to(cuda), k, p)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  rs_encode_np(data, gf.generator_matrix(k, p)))
    body = torch.from_numpy(rng.integers(0, 256, (64, 4160),
                                         dtype=np.uint8)).to(cuda)
    if k == 8:
        assert torch.equal(rs_ops.encode_blocks(body[:, :4096], k, p),
                           rs_encode_blocks_ref(body[:, :4096],
                                                rs_ops.mats(k, p)[1]))
    # the design's edges for this pair: B = 1, 3 and 513, a view 4 bytes
    # off 16-byte alignment
    body = torch.from_numpy(rng.integers(0, 256, (513, 4160),
                                         dtype=np.uint8)).to(cuda)
    n = 512 * k
    for view in (body[:1, :n], body[:3, :n], body[:, :n], body[:, 4:4 + n]):
        assert torch.equal(rs_ops.encode_blocks(view, k, p),
                           rs_encode_blocks_ref(view, rs_ops.mats(k, p)[1]))
