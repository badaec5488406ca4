"""The port's byte planes (repro_torch.net.bytesops, net/frames.py) against
the reference's, bit for bit, on the same numpy inputs made from a seed.

Field reads come back as the reference's uint32 and the port's int64
holding the same unsigned values; payloads and lengths keep their dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.net import bytesops as JB
from repro.net import frames as JF
from repro_torch.net import bytesops as TB
from repro_torch.net import frames as TF


def _batch(seed, B, L):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 256, (B, L), dtype=np.uint8)


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if j.dtype == np.uint32:
        assert t.dtype == np.int64
        np.testing.assert_array_equal(j.astype(np.int64), t)
    else:
        assert j.dtype == t.dtype, (j.dtype, t.dtype)
        np.testing.assert_array_equal(j, t)


@pytest.mark.parametrize("L", [1, 2, 17, 129])
def test_field_reads_static_and_per_row(L):
    rng, data = _batch(L, 9, L)
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    for off in sorted({0, 1, L // 2, L - 4, L - 2, L - 1} & set(range(L))):
        _eq(JB.u8(jd, off), TB.u8(td, off))
        if off + 2 <= L:
            _eq(JB.be16(jd, off), TB.be16(td, off))
        if off + 4 <= L:
            _eq(JB.be32(jd, off), TB.be32(td, off))
    # per-row offsets, in range, negative and past the end
    off = rng.integers(-L - 3, L + 4, 9).astype(np.int32)
    jo, to = jnp.asarray(off), torch.from_numpy(off)
    _eq(JB.u8(jd, jo), TB.u8(td, to))
    _eq(JB.be16(jd, jo), TB.be16(td, to))
    _eq(JB.be32(jd, jo), TB.be32(td, to))


@pytest.mark.parametrize("L", [8, 33, 64])
def test_field_writes(L):
    rng, data = _batch(100 + L, 6, L)
    val = rng.integers(0, 2 ** 32, 6, dtype=np.uint64)
    jv = jnp.asarray(val.astype(np.uint32))
    tv = torch.from_numpy(val.astype(np.int64))
    for off in (0, 3, L - 4):
        _eq(JB.set_u8(jnp.asarray(data), off, jv),
            TB.set_u8(torch.from_numpy(data.copy()), off, tv))
        _eq(JB.set_be16(jnp.asarray(data), off, jv),
            TB.set_be16(torch.from_numpy(data.copy()), off, tv))
        _eq(JB.set_be32(jnp.asarray(data), off, jv),
            TB.set_be32(torch.from_numpy(data.copy()), off, tv))
    blk = rng.integers(0, 256, (6, 5), dtype=np.uint8)
    for off in (0, 2, L - 5, L - 2):             # the last one is clamped
        _eq(JB.write_bytes(jnp.asarray(data), off, jnp.asarray(blk)),
            TB.write_bytes(torch.from_numpy(data.copy()), off,
                           torch.from_numpy(blk)))


@pytest.mark.parametrize("L", [1, 16, 31, 64])
def test_shifts_static_per_row_and_masked(L):
    rng, data = _batch(200 + L, 7, L)
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    mask = rng.integers(0, 2, 7).astype(bool)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for n in (0, 1, 9, L - 1, L, L + 3, -2):
        _eq(JB.shift_left(jd, n), TB.shift_left(td, n))
        _eq(JB.shift_right(jd, n), TB.shift_right(td, n))
        _eq(JB.shift_left(jd, n, jm), TB.shift_left(td, n, tm))
        _eq(JB.shift_right(jd, n, jm), TB.shift_right(td, n, tm))
    per_row = rng.integers(-3, L + 3, 7).astype(np.int32)
    jn, tn = jnp.asarray(per_row), torch.from_numpy(per_row)
    _eq(JB.shift_left(jd, jn), TB.shift_left(td, tn))
    _eq(JB.shift_right(jd, jn), TB.shift_right(td, tn))
    _eq(JB.shift_left(jd, jn, jm), TB.shift_left(td, tn, tm))
    _eq(JB.shift_right(jd, jn, jm), TB.shift_right(td, tn, tm))


@pytest.mark.parametrize("L,start", [(1, 0), (2, 1), (7, 0), (60, 14),
                                     (128, 0), (513, 1), (513, 14)])
def test_checksums_lengths_zero_odd_full_and_beyond(L, start):
    rng, data = _batch(300 + L + start, 10, L)
    span = max(L - start, 0)
    length = np.array([0, 1, 3, span, span + 1, span + 500, -4,
                       *rng.integers(0, span + 2, 3)], np.int32)
    pseudo = rng.integers(0, 2 ** 20, 10).astype(np.uint32)
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    jl, tl = jnp.asarray(length), torch.from_numpy(length)
    _eq(JB.checksum16(jd, start, jl), TB.checksum16(td, start, tl))
    _eq(JB.checksum16_with_pseudo(jd, start, jl, jnp.asarray(pseudo)),
        TB.checksum16_with_pseudo(td, start, tl,
                                  torch.from_numpy(pseudo.astype(np.int64))))


def test_pseudo_header_sum_and_numpy_oracle():
    rng = np.random.default_rng(7)
    ips = rng.integers(0, 2 ** 32, (2, 16), dtype=np.uint64)
    proto = rng.integers(0, 256, 16).astype(np.uint32)
    ln = rng.integers(0, 2 ** 16, 16).astype(np.uint32)
    got = TB.pseudo_header_sum(*(torch.from_numpy(a.astype(np.int64))
                                 for a in (ips[0], ips[1], proto, ln)))
    want = JB.pseudo_header_sum(jnp.asarray(ips[0].astype(np.uint32)),
                                jnp.asarray(ips[1].astype(np.uint32)),
                                jnp.asarray(proto), jnp.asarray(ln))
    _eq(want, got)
    for n in (0, 1, 2, 19, 64, 333):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert TF.np_checksum16(blob) == JB.np_checksum16(blob)


def test_frame_builders_and_arena_match_reference():
    frames = [
        JF.udp_rpc_frame(JF.ip("10.0.0.2"), JF.ip("10.0.0.1"), 5555, 9000,
                         b"hello"),
        JF.udp_rpc_frame(JF.ip("10.0.0.2"), JF.ip("10.0.0.1"), 5555, 9000,
                         b"v", vlan=7),
        JF.tcp_eth_frame(JF.ip("10.0.0.2"), JF.ip("10.0.0.1"), 4000, 80,
                         1000, 0, JF.TCP_SYN),
    ]
    ported = [
        TF.udp_rpc_frame(TF.ip("10.0.0.2"), TF.ip("10.0.0.1"), 5555, 9000,
                         b"hello"),
        TF.udp_rpc_frame(TF.ip("10.0.0.2"), TF.ip("10.0.0.1"), 5555, 9000,
                         b"v", vlan=7),
        TF.tcp_eth_frame(TF.ip("10.0.0.2"), TF.ip("10.0.0.1"), 4000, 80,
                         1000, 0, TF.TCP_SYN),
    ]
    assert frames == ported
    for a, b in zip(JF.to_batch(frames, 96), TF.to_batch(ported, 96)):
        np.testing.assert_array_equal(a, b)
    ja, ta = JF.FrameArena(2, 2, 96), TF.FrameArena(2, 2, 96)
    assert ja.fill(frames) == ta.fill(ported) == 2
    np.testing.assert_array_equal(ja.payload, ta.payload)
    np.testing.assert_array_equal(ja.length, ta.length)
    with pytest.raises(ValueError):
        TF.to_batch(ported, 10)
