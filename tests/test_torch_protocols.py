"""Every parse_ex and build of the port's eth / ipv4 / udp / rpc tiles
against the reference, bit for bit: payload bytes, lengths, meta fields,
ok flags and drop-reason codes.

Inputs: the golden frames of tests/test_net_stack.py, the runt-UDP and
truncation cases of tests/test_ingest_fuzz.py (every cut of a frame,
the empty frame named as its own case) and Hypothesis random bytes
(``deadline=None``: the reference's first call compiles).
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp_compat import given, settings, st

from repro.net import eth as jeth, frames as F, ipv4 as jipv4
from repro.net import rpc as jrpc, udp as judp
from repro_torch.net import eth as teth, ipv4 as tipv4
from repro_torch.net import rpc as trpc, udp as tudp

IP_C, IP_S = F.ip("10.0.0.2"), F.ip("10.0.0.1")
L = 160


def _np(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _same(j, t, what):
    """Equal trees of outputs: tuples, meta dicts and arrays."""
    if isinstance(j, dict):
        assert j.keys() == t.keys(), what
        for k in j:
            _same(j[k], t[k], f"{what}.{k}")
    elif isinstance(j, (tuple, list)):
        assert len(j) == len(t), what
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{what}[{i}]")
    else:
        a, b = _np(j), _np(t)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


def rx_chain(frames, width=L, rows=64):
    """eth -> ipv4 -> udp -> rpc parse_ex on both packages, every stage's
    outputs compared; returns the reference's outputs.  Batches are padded
    with empty frames to one shape, so the reference compiles its ops
    once."""
    p, l = F.to_batch(list(frames) + [b""] * (rows - len(frames)), width)
    jp, jl = jnp.asarray(p), jnp.asarray(l)
    tp, tl = torch.from_numpy(p), torch.from_numpy(l)
    je, te = jeth.parse(jp, jl), teth.parse(tp, tl)
    _same(je, te, "eth.parse")
    ji, ti = jipv4.parse_ex(je[0], je[1]), tipv4.parse_ex(te[0], te[1])
    _same(ji, ti, "ipv4.parse_ex")
    jm, tm = dict(je[2]), dict(te[2])
    jm.update(ji[2])
    tm.update(ti[2])
    ju, tu = judp.parse_ex(ji[0], ji[1], jm), tudp.parse_ex(ti[0], ti[1], tm)
    _same(ju, tu, "udp.parse_ex")
    jr, tr = jrpc.parse_ex(ju[0], ju[1]), trpc.parse_ex(tu[0], tu[1])
    _same(jr, tr, "rpc.parse_ex")
    return ji, ju, jr


def golden():
    corrupt = bytearray(F.udp_rpc_frame(IP_C, IP_S, 5555, 9000,
                                        jrpc.np_frame(1, 3, b"x")))
    corrupt[20] ^= 0xFF
    return [
        F.udp_rpc_frame(IP_C, IP_S, 5555, 9000, jrpc.np_frame(1, 1, b"hello")),
        F.udp_rpc_frame(IP_C, IP_S, 5555, 9000, jrpc.np_frame(2, 2, b"v"),
                        vlan=7),
        bytes(corrupt),
        F.udp_rpc_frame(IP_C, IP_S, 5555, 9000, b"\x00\x01no magic"),
        F.udp_rpc_frame(IP_C, IP_S, 5555, 9000, b"hello"),  # short rpc
        F.udp_rpc_frame(IP_C, IP_S, 1, 2, jrpc.np_frame(5, 2 ** 32 - 1,
                                                        bytes(100))),
    ]


def test_golden_frames_parse_identically():
    ji, ju, jr = rx_chain(golden())
    ok = np.asarray(ji[3] & ju[3] & jr[3])
    assert ok[:6].tolist() == [True, True, False, False, False, True]


def test_runt_udp_and_length_past_buffer():
    dgrams = [struct.pack("!HHHH", 5000, 9400, ulen, 0) + b"abcd"
              for ulen in range(0, 8)]
    dgrams.append(struct.pack("!HHHH", 5000, 9400, 12, 0) + b"abcd")
    dgrams.append(struct.pack("!HHHH", 5000, 9400, 200, 0) + b"xy")
    p, l = F.to_batch(dgrams, 32)
    meta_j = {"src_ip": jnp.full((10,), IP_C, jnp.uint32),
              "dst_ip": jnp.full((10,), IP_S, jnp.uint32)}
    meta_t = {"src_ip": torch.full((10,), IP_C, dtype=torch.int64),
              "dst_ip": torch.full((10,), IP_S, dtype=torch.int64)}
    j = judp.parse_ex(jnp.asarray(p), jnp.asarray(l), meta_j)
    t = tudp.parse_ex(torch.from_numpy(p), torch.from_numpy(l), meta_t)
    _same(j, t, "udp.parse_ex")
    assert np.asarray(j[3]).tolist() == [False] * 8 + [True, False]


def _rpc_frame():
    return F.udp_rpc_frame(IP_C, IP_S, 5000, 9400,
                           jrpc.np_frame(jrpc.MSG_LM_GENERATE, 1,
                                         b"\x00\x07\x00\x02\x00\x03"))


def test_empty_frame():
    ji, ju, jr = rx_chain([b"", _rpc_frame()])
    assert not bool(ji[3][0] & ju[3][0] & jr[3][0])


def test_every_truncation():
    frame = _rpc_frame()
    ji, ju, jr = rx_chain([frame] + [frame[:cut] for cut in range(len(frame))])
    ok = np.asarray(ji[3] & ju[3] & jr[3])
    assert ok[0] and not ok[1:len(frame) + 1].any()


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(st.binary(min_size=0, max_size=150), min_size=1,
                max_size=4))
def test_fuzz_random_bytes(blobs):
    rx_chain(blobs)


def _tx_meta(n, rng):
    u32 = lambda: rng.integers(0, 2 ** 32, n, dtype=np.uint64)  # noqa: E731
    u16 = lambda: rng.integers(0, 2 ** 16, n, dtype=np.uint64)  # noqa: E731
    m = {"src_ip": u32(), "dst_ip": u32(), "src_port": u16(),
         "dst_port": u16(), "ip_proto": np.full(n, 17, np.uint64),
         "eth_dst_hi": u32(), "eth_dst_lo": u16(), "eth_src_hi": u32(),
         "eth_src_lo": u16(), "ethertype": np.full(n, 0x0800, np.uint64),
         "msg_type": rng.integers(0, 256, n, dtype=np.uint64),
         "req_id": u32()}
    return ({k: jnp.asarray(v.astype(np.uint32)) for k, v in m.items()},
            {k: torch.from_numpy(v.astype(np.int64)) for k, v in m.items()})


@pytest.mark.parametrize("width", [64, 129])
def test_builds(width):
    rng = np.random.default_rng(width)
    n = 6
    body = rng.integers(0, 256, (n, width), dtype=np.uint8)
    blen = np.array([0, 1, 7, 20, width - 60, width], np.int32)
    mj, mt = _tx_meta(n, rng)
    jb, jl = jnp.asarray(body), jnp.asarray(blen)
    tb, tl = torch.from_numpy(body), torch.from_numpy(blen)
    j = jrpc.build(jb, jl, mj["msg_type"], mj["req_id"])
    t = trpc.build(tb, tl, mt["msg_type"], mt["req_id"])
    _same(j, t, "rpc.build")
    _same(jrpc.build(jb, jl, 5, mj["req_id"]),
          trpc.build(tb, tl, 5, mt["req_id"]), "rpc.build static type")
    for csum in (True, False):
        _same(judp.build(j[0], j[1], mj, with_checksum=csum),
              tudp.build(t[0], t[1], mt, with_checksum=csum), "udp.build")
    j = judp.build(j[0], j[1], mj)
    t = tudp.build(t[0], t[1], mt)
    ident = rng.integers(0, 2 ** 16, n, dtype=np.uint64)
    _same(jipv4.build(j[0], j[1], mj), tipv4.build(t[0], t[1], mt),
          "ipv4.build")
    _same(jipv4.build(j[0], j[1], mj, jnp.asarray(ident.astype(np.uint32))),
          tipv4.build(t[0], t[1], mt, torch.from_numpy(ident.astype(
              np.int64))), "ipv4.build ident")
    j = jipv4.build(j[0], j[1], mj)
    t = tipv4.build(t[0], t[1], mt)
    _same(jeth.build(j[0], j[1], mj), teth.build(t[0], t[1], mt),
          "eth.build")
