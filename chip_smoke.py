#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``);
  3. hold each kernel against its plain PyTorch version on the card, bit
     for bit (checksum: B=512, L=4160 and odd widths, lengths 0, odd, L
     and > L, with and without the pseudo-header term, aligned and not;
     RS: the (k, p) sweep of the reference's kernel tests and 512
     requests of 4 KiB), and time both at the main path's shapes;
  4. the main path: an ``rs_serve`` RPC stack (eth -> ip -> udp/rpc ->
     RS(8,2) -> udp -> ip -> eth) on B=512 frames of L=4160: one
     ``rx_tx``, then ``run_stream`` over N=32 batches under
     ``torch.cuda.set_sync_debug_mode("error")``, held equal to 32
     sequential ``rx_tx`` calls; every reply parsed with numpy, its
     checksums verified and its parity held against ``rs_encode_np``; the
     drop table held against the bad frames; kernel launches counted;
  5. the same frames through the port on the CPU (plain versions) at N=2,
     outputs and whole state held equal to the card's;
  6. the app-group path: ``udp_topology`` with the replicated RS app
     (L=4160), then echo at L=1536, the same way.

Prints the kernels' line ``{"kernels": [...]}`` and the main path's timing
line, then, last, ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result line, when CUDA is absent or the repository is not beside it.
"""
from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B = 512          # frames per batch
L = 4160         # frame width: holds a 4 KiB RS request (4147 bytes)
N = 32           # batches per stream
L_ECHO = 1536    # MTU-width arena of the echo path
N_APP = 8        # batches per stream on the app-group path
N_CPU = 2        # batches held against the CPU run
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor rate (data sheet)
SEED = 0

IP_C, IP_S = 0x0A000002, 0x0A000001      # 10.0.0.2 -> 10.0.0.1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# frames (host side, numpy) and reply checks


def make_rs_batches(F, rpc, rng, n_batches, bad=True):
    """n_batches x B frames: RS requests, and in each batch two frames
    each of a bad IP checksum, a runt UDP header, a bad RPC magic, an
    unrouted msg_type and a short RS request.  Returns (payload (n, B, L),
    length (n, B), kind (n, B) str codes, blocks {(b, i): 4 KiB})."""
    payload = np.zeros((n_batches, B, L), np.uint8)
    length = np.zeros((n_batches, B), np.int32)
    kinds, blocks = [], {}
    for b in range(n_batches):
        row_kinds = []
        for i in range(B):
            kind = "rs"
            if bad and i >= B - 10:
                kind = ("bad_ip", "runt", "bad_magic", "unrouted",
                        "short")[(i - (B - 10)) // 2]
            rid = b * B + i
            if kind in ("rs", "bad_ip"):
                blk = rng.integers(0, 256, 4096, dtype="uint8").tobytes()
                fr = F.udp_rpc_frame(IP_C, IP_S, 5000 + i % 64, 9400,
                                     rpc.np_frame(rpc.MSG_RS_ENCODE, rid,
                                                  blk))
                if kind == "rs":
                    blocks[(b, i)] = blk
                else:
                    fr = bytearray(fr)
                    fr[20] ^= 0xFF          # an IP header byte
                    fr = bytes(fr)
            elif kind == "runt":
                body = rpc.np_frame(rpc.MSG_RS_ENCODE, rid, b"runt")
                dg = struct.pack("!HHHH", 5000, 9400, 4, 0) + body
                fr = F.eth_frame(b"\x02\x00\x00\x00\x00\x01",
                                 b"\x02\x00\x00\x00\x00\x02", 0x0800,
                                 F.ipv4_packet(IP_C, IP_S, 17, dg))
            elif kind == "bad_magic":
                body = b"\x00\x00" + rpc.np_frame(rpc.MSG_RS_ENCODE, rid,
                                                  b"x" * 64)[2:]
                fr = F.udp_rpc_frame(IP_C, IP_S, 5000, 9400, body)
            elif kind == "unrouted":
                fr = F.udp_rpc_frame(IP_C, IP_S, 5000, 9400,
                                     rpc.np_frame(rpc.MSG_ECHO, rid, b"hi"))
            else:
                fr = F.udp_rpc_frame(IP_C, IP_S, 5000, 9400,
                                     rpc.np_frame(rpc.MSG_RS_ENCODE, rid,
                                                  b"s" * 100))
            payload[b, i, :len(fr)] = memoryview(fr)
            length[b, i] = len(fr)
            row_kinds.append(kind)
        kinds.append(row_kinds)
    return payload, length, kinds, blocks


def np_csum_ok(rows, pseudo=None):
    """RFC 1071 verification of (R, n) byte rows: True where the ones-
    complement sum (plus a pseudo-header sum) folds to 0xFFFF."""
    r = rows.astype(np.uint64)
    if r.shape[1] % 2:
        r = np.pad(r, ((0, 0), (0, 1)))
    s = ((r[:, 0::2] << 8) | r[:, 1::2]).sum(axis=1)
    if pseudo is not None:
        s = s + pseudo
    while (s >> 16).any():
        s = (s & 0xFFFF) + (s >> 16)
    return s == 0xFFFF


def check_replies(gf, rs_encode_np, tx, txl, rows, blocks, resp_len, what):
    """Parse the replies of the served rows ((b, i) pairs) with numpy:
    Ethernet, IPv4 and UDP headers and checksums, the RPC frame, and the
    parity against rs_encode_np.  Returns the number of replies checked."""
    check(len(rows) > 0, f"{what}: no served rows")
    bi = np.asarray(rows)
    q = tx[bi[:, 0], bi[:, 1]]
    ql = txl[bi[:, 0], bi[:, 1]]
    want_len = 14 + 20 + 8 + 9 + resp_len
    check((ql == want_len).all(), f"{what}: reply lengths {set(ql.tolist())}")
    check((q[:, 12] == 0x08).all() and (q[:, 13] == 0).all(),
          f"{what}: ethertype")
    check(bytes(q[0, 0:6]) == b"\x02\x00\x00\x00\x00\x02", f"{what}: dst MAC")
    check(np_csum_ok(q[:, 14:34]).all(), f"{what}: IP checksum")
    ulen = 8 + 9 + resp_len
    pseudo = ((IP_S >> 16) + (IP_S & 0xFFFF) + (IP_C >> 16)
              + (IP_C & 0xFFFF) + 17 + ulen)
    check(np_csum_ok(q[:, 34:34 + ulen], np.uint64(pseudo)).all(),
          f"{what}: UDP checksum")
    rpc_hdr = q[:, 42:51]
    check((rpc_hdr[:, 0] == 0xBE).all() and (rpc_hdr[:, 1] == 0xE5).all(),
          f"{what}: RPC magic")
    plen = (rpc_hdr[:, 7].astype(int) << 8) | rpc_hdr[:, 8]
    check((plen == resp_len).all(), f"{what}: RPC payload length")
    data = np.stack([np.frombuffer(blocks[tuple(r)], np.uint8)
                     for r in rows])                       # (R, 4096)
    shards = data.reshape(-1, 8, 512).transpose(1, 0, 2).reshape(8, -1)
    want = rs_encode_np(shards, gf.generator_matrix(8, 2))
    want = want.reshape(2, -1, 512).transpose(1, 0, 2).reshape(-1, 1024)
    check(np.array_equal(q[:, 51:51 + resp_len], want),
          f"{what}: RS parity differs from rs_encode_np")
    return len(rows)


def flat_equal(convert, a, b, what):
    fa = convert.flatten(convert.state_to_numpy(a))
    fb = convert.flatten(convert.state_to_numpy(b))
    check(fa.keys() == fb.keys(), f"{what}: keys {fa.keys() ^ fb.keys()}")
    for k in fa:
        check(fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]),
              f"{what}: {k} differs")


# ---------------------------------------------------------------------------
# timing


def time_cuda(torch, fn, iters=50, warmup=3):
    """Milliseconds per call by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=50, only=None):
    """Device time per call from torch.profiler (CUDA activity only, so
    every event is a kernel or a copy on the card): the sum of the events'
    device time, over `iters` calls, divided by `iters`.  ``only`` keeps
    the events whose name holds that string.  Unlike `time_cuda`, it
    leaves out the gaps where the card waits for the host to launch.
    Returns (ms per call, events per call, the 8 largest events as
    (ms per call, count per call, name))."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count, top = 0.0, 0, []
    for e in prof.key_averages():
        if only is None or only in e.key:
            total_us += e.self_device_time_total
            count += e.count
            top.append((e.self_device_time_total / 1e3 / iters, e.count
                        // iters, e.key[:70]))
    return total_us / 1e3 / iters, count / iters, sorted(top)[::-1][:8]


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2

    from repro_torch import _build, convert
    from repro_torch.apps import echo, reed_solomon
    from repro_torch.kernels.checksum import ops as csum_ops
    from repro_torch.kernels.checksum.ref import checksum16_ref
    from repro_torch.kernels.rs_encode import gf
    from repro_torch.kernels.rs_encode import ops as rs_ops
    from repro_torch.kernels.rs_encode.ref import (rs_encode_blocks_ref,
                                                   rs_encode_np)
    from repro_torch.net import bytesops as BO, frames as F, rpc
    from repro_torch.net.stack import (UdpStack, rpc_serve_topology,
                                       udp_topology)

    dev = torch.device("cuda")
    t_all = time.time()

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.time()
    _build.load()
    print(f"[build] {_build.library_path().name} in {time.time() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")

    # ---- 3. kernels against their plain versions --------------------------
    rng = np.random.default_rng(SEED)
    n_cases = 0
    for width in (L, L + 1, 1535, 64, 1):
        data = torch.from_numpy(
            rng.integers(0, 256, (B, width), dtype=np.uint8)).to(dev)
        lens = np.concatenate([[0, 1, 7, width, width + 1, width + 999, -3],
                               rng.integers(0, width + 2, B - 7)])
        lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
        pseudo = torch.from_numpy(
            rng.integers(0, 1 << 20, B).astype(np.int64)).to(dev)
        for start in (0, 1, 14):
            for ps in (None, pseudo):
                got = csum_ops.checksum16(data, start, lens, ps)
                want = checksum16_ref(data, start, lens, ps)
                check(torch.equal(got, want),
                      f"checksum kernel != plain at width {width} start "
                      f"{start} pseudo {ps is not None}")
                n_cases += 1
        view = data[:, 1:] if width > 1 else data      # unaligned rows
        check(torch.equal(csum_ops.checksum16(view, 0, lens),
                          checksum16_ref(view, 0, lens)),
              f"checksum kernel != plain on a strided view, width {width}")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"[kernels] checksum: {n_cases} cases bit-identical to the plain "
          f"version")

    n_cases = 0
    for k, p in ((8, 2), (4, 2), (10, 4), (6, 3)):
        gm = gf.generator_matrix(k, p)
        for n in (4096, 16384):
            d = rng.integers(0, 256, (k, n), dtype=np.uint8)
            got = rs_ops.rs_encode(torch.from_numpy(d).to(dev), k, p)
            ref = rs_encode_blocks_ref(torch.from_numpy(d).to(dev).reshape(
                1, k * n), rs_ops.mats(k, p)[1]).reshape(p, n)
            check(torch.equal(got, ref), f"RS kernel != plain at k={k} "
                  f"p={p} n={n}")
            check(np.array_equal(got.cpu().numpy(), rs_encode_np(d, gm)),
                  f"RS kernel != rs_encode_np at k={k} p={p} n={n}")
            n_cases += 1
    body = torch.from_numpy(
        rng.integers(0, 256, (B, L), dtype=np.uint8)).to(dev)
    blocks_view = body[:, :reed_solomon.REQ]       # rs_serve's strided view
    got = rs_ops.encode_blocks(blocks_view, 8, 2)
    want = rs_encode_blocks_ref(blocks_view, rs_ops.mats(8, 2)[1])
    check(torch.equal(got, want), "RS kernel != plain on 512 requests")
    torch.cuda.synchronize()
    print(f"[kernels] rs_encode: {n_cases + 1} cases bit-identical to the "
          f"plain version and to rs_encode_np")

    # main-path shapes: the four checksum calls of one RS batch, as an
    # rx_tx on the card makes them, and the RS kernel's (512, 4096) view of
    # the request bodies
    frames_p, frames_l, kinds, blocks = make_rs_batches(F, rpc, rng, N)
    pay0 = torch.from_numpy(frames_p[0]).to(dev)
    len0 = torch.from_numpy(frames_l[0]).to(dev)
    csum_calls = []

    def recording(payload, start, length, pseudo=None):
        csum_calls.append((payload.clone(), start, length.clone(),
                           None if pseudo is None else pseudo.clone()))
        return csum_ops.checksum16(payload, start, length, pseudo)

    cap = UdpStack([], IP_S, topo=rpc_serve_topology(
        [("rs", "rs_serve", rpc.MSG_RS_ENCODE)]))
    # the byte planes reach the kernel through their `csum_ops` module
    BO.csum_ops = types.SimpleNamespace(checksum16=recording)
    try:
        cap.rx_tx(cap.init_state(), pay0, len0)
    finally:
        BO.csum_ops = csum_ops
    check(len(csum_calls) == 4, f"{len(csum_calls)} checksum calls in one "
          f"batch, expected 4 (ip_rx, udp_rx, udp_tx, ip_tx)")
    # kernel time: device time of the kernel alone (profiler); call time:
    # CUDA events around back-to-back wrapper calls, which includes the
    # host's launch cost when that is longer than the kernel
    csum_sites = []
    for site, (cp, cs, cl, cps) in zip(("ip_rx", "udp_rx", "udp_tx",
                                        "ip_tx"), csum_calls):
        call = lambda: csum_ops.checksum16(cp, cs, cl, cps)  # noqa: E731
        plain = lambda: checksum16_ref(cp, cs, cl, cps)      # noqa: E731
        err = (call() - plain()).abs().max().item()
        check(err == 0, f"checksum kernel != plain at the {site} shape")
        valid = int(cl.clamp(0, max(cp.shape[1] - cs, 0)).sum().item())
        nbytes = valid + cp.shape[0] * (4 + 8 + (0 if cps is None else 8))
        b_ms, b_by = bound_ms(nbytes, valid)
        ms, _, _ = device_ms(torch, call, iters=200, only="checksum16")
        p_ms, p_kernels, _ = device_ms(torch, plain, iters=20)
        csum_sites.append({
            "site": site, "shape": f"({cp.shape[0]}, {cp.shape[1]}) uint8 "
            f"from byte {cs}, {valid} valid bytes, pseudo "
            f"{cps is not None}", "max_abs_err": err, "ms": ms,
            "plain_ms": p_ms, "plain_kernels": p_kernels,
            "call_ms": time_cuda(torch, call, iters=200),
            "plain_call_ms": time_cuda(torch, plain, iters=20),
            "bound_ms": b_ms, "bound_by": b_by})
    udp_rx_site = csum_sites[1]

    rs_call = lambda: rs_ops.encode_blocks(blocks_view, 8, 2)       # noqa
    rs_plain = lambda: rs_encode_blocks_ref(                        # noqa
        blocks_view, rs_ops.mats(8, 2)[1])
    ms_r, _, _ = device_ms(torch, rs_call, iters=200, only="rs_encode")
    plain_r, plain_r_kernels, _ = device_ms(torch, rs_plain, iters=10)
    call_r = time_cuda(torch, rs_call, iters=200)
    call_plain_r = time_cuda(torch, rs_plain, iters=10)
    r_bytes = B * 4096 + B * 1024
    br, br_by = bound_ms(r_bytes, 2 * B * 512 * 8 * 2)   # GF mul + xor
    err_r = (rs_call().int() - rs_plain().int()).abs().max().item()
    for s in csum_sites:
        print(f"[kernels] checksum {s['site']} {s['shape']}: kernel "
              f"{s['ms']:.5f} ms, call {s['call_ms']:.5f} ms, plain "
              f"{s['plain_ms']:.5f} ms ({s['plain_kernels']:.0f} kernels; "
              f"call {s['plain_call_ms']:.5f}), bound {s['bound_ms']:.5f} ms")
    print(f"[kernels] rs_encode: kernel {ms_r:.5f} ms, call {call_r:.5f} ms, "
          f"plain {plain_r:.5f} ms ({plain_r_kernels:.0f} kernels; call "
          f"{call_plain_r:.5f}), bound {br:.5f} ms")

    # ---- 4. the main path ---------------------------------------------------
    topo = rpc_serve_topology([("rs", "rs_serve", rpc.MSG_RS_ENCODE)])
    stack = UdpStack([], IP_S, topo=topo)
    check(stack.device.type == "cuda", "UdpStack did not default to cuda")
    order = stack.pipeline.order
    arena_p = torch.from_numpy(frames_p).to(dev)
    arena_l = torch.from_numpy(frames_l).to(dev)
    st_single = stack.init_state()
    st_stream = stack.init_state()
    st_seq = stack.init_state()
    torch.cuda.synchronize()

    csum_ops.checksum16.launches = 0
    rs_ops.encode_blocks.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    st_single, q0, ql0, alive0, info0 = stack.rx_tx(st_single, arena_p[0],
                                                    arena_l[0])
    st_stream, outs = stack.run_stream(st_stream, arena_p, arena_l)
    seq = []
    for b in range(N):
        st_seq, q, ql, al, inf = stack.rx_tx(st_seq, arena_p[b], arena_l[b])
        seq.append((q, ql, al, inf["rs"]))
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {"checksum16": csum_ops.checksum16.launches,
                "rs_encode": rs_ops.encode_blocks.launches}
    batches_run = 1 + 2 * N
    check(launches["checksum16"] == 4 * batches_run,
          f"checksum launches {launches['checksum16']} != 4 per batch")
    check(launches["rs_encode"] == batches_run,
          f"rs_encode launches {launches['rs_encode']} != 1 per batch")
    print(f"[main] launches over {batches_run} batches with no host sync: "
          f"{launches}")

    for b in range(N):
        q, ql, al, served = seq[b]
        check(torch.equal(q, outs["tx_payload"][b])
              and torch.equal(ql, outs["tx_len"][b])
              and torch.equal(al, outs["alive"][b])
              and torch.equal(served, outs["info"]["rs"][b]),
              f"run_stream batch {b} != sequential rx_tx")
    flat_equal(convert, st_stream, st_seq, "run_stream state vs "
               "sequential rx_tx")
    check(torch.equal(q0, outs["tx_payload"][0]), "rx_tx != stream batch 0")

    tx = outs["tx_payload"].cpu().numpy()
    txl = outs["tx_len"].cpu().numpy()
    alive = outs["alive"].cpu().numpy()
    served = outs["info"]["rs"].cpu().numpy()
    kind_arr = np.asarray(kinds)
    check(np.array_equal(served, kind_arr == "rs"), "served rows != RS rows")
    dead = np.isin(kind_arr, ("bad_ip", "runt", "bad_magic"))
    check(np.array_equal(alive, ~dead), "alive rows != good frames")
    rows = [tuple(x) for x in np.argwhere(served)]
    n_checked = check_replies(gf, rs_encode_np, tx, txl, rows,
                              blocks, 1024, "rs_serve")
    drops = st_stream["telemetry"]["drops"].cpu().numpy()
    from repro_torch.obs import reasons as R
    want = np.zeros_like(drops)
    want[order.index("ip_rx"), R.IP_CSUM] = 2 * N
    want[order.index("udp_rx"), R.RUNT_UDP] = 2 * N
    want[order.index("udp_rx"), R.RPC_MAGIC] = 2 * N
    want[order.index("rs"), R.APP_BAD_REQ] = 2 * N
    check(np.array_equal(drops, want), f"drop table {drops.nonzero()}")
    apps = st_stream["apps"]["rs"]
    check(int(apps["ops"]) == len(rows) and int(apps["bytes"])
          == 4096 * len(rows), "rs_serve ops/bytes counters")
    print(f"[main] {n_checked} RS replies parsed, checksums valid, parity "
          f"== rs_encode_np; drop table matches the bad frames; stream == "
          f"{N} sequential rx_tx")

    # timing: per batch and streamed (host clock around synchronized work)
    st_t = stack.init_state()
    stack.rx_tx(st_t, arena_p[0], arena_l[0])
    torch.cuda.synchronize()
    per_batch = []
    for _ in range(10):
        t0 = time.perf_counter()
        st_t, *_ = stack.rx_tx(st_t, arena_p[0], arena_l[0])
        torch.cuda.synchronize()
        per_batch.append((time.perf_counter() - t0) * 1e3)
    streamed = []
    for _ in range(3):
        st_t = stack.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_t, _ = stack.run_stream(st_t, arena_p, arena_l)
        torch.cuda.synchronize()
        streamed.append((time.perf_counter() - t0) * 1e3)
    rx_ms = float(np.median(per_batch))
    stream_ms = float(np.median(streamed))
    served_per_stream = int(served.sum())
    st_t = stack.init_state()
    dev_ms, dev_kernels, dev_top = device_ms(torch, lambda: stack.run_stream(
        st_t, arena_p, arena_l), iters=1)
    busy = {"device_ms": dev_ms, "kernels": dev_kernels,
            "busy_share": dev_ms / stream_ms, "top": dev_top}
    main_line = {
        "main_path": {
            "card": card, "B": B, "L": L, "N": N,
            "rx_tx_ms_per_batch": rx_ms,
            "rx_tx_ms_samples": per_batch,
            "stream_ms_total": stream_ms,
            "stream_ms_samples": streamed,
            "stream_ms_per_batch": stream_ms / N,
            "frames_per_s_rx_tx": B / (rx_ms / 1e3),
            "frames_per_s_stream": B * N / (stream_ms / 1e3),
            "rs_requests_per_stream": served_per_stream,
            "rs_gbps_stream": served_per_stream * 4096 * 8
            / (stream_ms / 1e3) / 1e9,
            "device_busy": busy,
        }}

    # ---- 5. the CPU run of the same frames ---------------------------------
    cpu = UdpStack([], IP_S, topo=rpc_serve_topology(
        [("rs", "rs_serve", rpc.MSG_RS_ENCODE)]), device="cpu")
    st_c = cpu.init_state()
    st_c, cq, cql, cal, cinf = cpu.rx_tx(st_c, torch.from_numpy(frames_p[0]),
                                         torch.from_numpy(frames_l[0]))
    check(torch.equal(cq, q0.cpu()) and torch.equal(cql, ql0.cpu())
          and torch.equal(cal, alive0.cpu())
          and torch.equal(cinf["rs"], info0["rs"].cpu()),
          "CPU rx_tx != card rx_tx")
    flat_equal(convert, st_c, st_single, "CPU rx_tx state vs card")
    st_c2, couts = cpu.run_stream(cpu.init_state(),
                                  torch.from_numpy(frames_p[:N_CPU]),
                                  torch.from_numpy(frames_l[:N_CPU]))
    st_g2, gouts = stack.run_stream(stack.init_state(), arena_p[:N_CPU],
                                    arena_l[:N_CPU])
    for k in ("tx_payload", "tx_len", "alive"):
        check(torch.equal(couts[k], gouts[k].cpu()), f"CPU stream {k}")
    check(torch.equal(couts["info"]["rs"], gouts["info"]["rs"].cpu()),
          "CPU stream info")
    flat_equal(convert, st_c2, st_g2, "CPU stream state vs card")
    print(f"[cpu] rx_tx and a {N_CPU}-batch stream on the CPU equal the "
          f"card's outputs and state")

    # ---- 6. the app-group path ---------------------------------------------
    app_launches = {}
    for name, width in (("rs", L), ("echo", L_ECHO)):
        if name == "rs":
            app = reed_solomon.make(port=9000, n_replicas=4)
        else:
            app = echo.make(port=7)
        apps_l = [app]
        fr_p = np.zeros((N_APP, B, width), np.uint8)
        fr_l = np.zeros((N_APP, B), np.int32)
        bodies = {}
        for b in range(N_APP):
            for i in range(B):
                if name == "rs":
                    body = rng.integers(0, 256, 4096, dtype=np.uint8
                                        ).tobytes()
                else:
                    body = rng.integers(0, 256, int(rng.integers(
                        0, width - 51)), dtype=np.uint8).tobytes()
                bodies[(b, i)] = body
                fr = F.udp_rpc_frame(IP_C, IP_S, 6000 + i, app.port,
                                     rpc.np_frame(rpc.MSG_ECHO, b * B + i,
                                                  body))
                fr_p[b, i, :len(fr)] = memoryview(fr)
                fr_l[b, i] = len(fr)
        gstack = UdpStack(apps_l, IP_S, topo=udp_topology(apps_l))
        g_p = torch.from_numpy(fr_p).to(dev)
        g_l = torch.from_numpy(fr_l).to(dev)
        gs = gstack.init_state()
        gs_seq = gstack.init_state()
        torch.cuda.synchronize()
        csum_ops.checksum16.launches = 0
        rs_ops.encode_blocks.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        gs, gouts = gstack.run_stream(gs, g_p, g_l)
        seq = [gstack.rx_tx(gs_seq, g_p[0], g_l[0])]
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        app_launches[name] = {"checksum16": csum_ops.checksum16.launches,
                              "rs_encode": rs_ops.encode_blocks.launches}
        check(app_launches[name]["checksum16"] == 4 * (N_APP + 1),
              f"{name}: checksum launches {app_launches[name]}")
        if name == "rs":
            check(app_launches[name]["rs_encode"] == N_APP + 1,
                  f"{name}: rs launches {app_launches[name]}")
        _, q, ql, al, _ = seq[0]
        check(torch.equal(q, gouts["tx_payload"][0])
              and torch.equal(ql, gouts["tx_len"][0]),
              f"{name}: stream batch 0 != rx_tx")
        tx = gouts["tx_payload"].cpu().numpy()
        txl = gouts["tx_len"].cpu().numpy()
        check(gouts["alive"].all().item()
              and gouts["info"][app.name].all().item(),
              f"{name}: not every frame was served")
        rows = [(b, i) for b in range(N_APP) for i in range(B)]
        if name == "rs":
            check_replies(gf, rs_encode_np, tx, txl, rows, bodies,
                          1024, "rs app group")
            ops = gs["apps"]["rs"]["ops"].cpu().numpy()
            check(ops.tolist() == [N_APP * B // 4] * 4,
                  f"round robin over 4 replicas: {ops.tolist()}")
        else:
            for (b, i) in rows:
                body = bodies[(b, i)]
                check(txl[b, i] == 51 + len(body)
                      and bytes(tx[b, i, 51:51 + len(body)]) == body,
                      f"echo reply {(b, i)}")
            check(np_csum_ok(tx[:, :, 14:34].reshape(-1, 20)).all(),
                  "echo IP checksums")
            check(int(gs["apps"]["echo"]["served"][0]) == N_APP * B,
                  "echo served counter")
        cstack = UdpStack(apps_l, IP_S, topo=udp_topology(apps_l),
                          device="cpu")
        cs, couts = cstack.run_stream(cstack.init_state(),
                                      torch.from_numpy(fr_p[:N_CPU]),
                                      torch.from_numpy(fr_l[:N_CPU]))
        gs2, gouts2 = gstack.run_stream(gstack.init_state(), g_p[:N_CPU],
                                        g_l[:N_CPU])
        for k in ("tx_payload", "tx_len", "alive"):
            check(torch.equal(couts[k], gouts2[k].cpu()),
                  f"{name}: CPU stream {k}")
        flat_equal(convert, cs, gs2, f"{name}: CPU state vs card")
        print(f"[app] {name} group (L={width}): {N_APP} batches streamed with "
              f"no host sync, replies checked, CPU run equal; launches "
              f"{app_launches[name]}")

    # ---- 7. results ---------------------------------------------------------
    kernels = [
        {"name": "checksum16", "route": "cuda",
         "source": "src/repro_torch/csrc/checksum.cu",
         "replaces": "src/repro/kernels/checksum/kernel.py:32",
         "launches": launches["checksum16"],
         "max_abs_err": max(s["max_abs_err"] for s in csum_sites),
         "bit_identical_to_plain": all(s["max_abs_err"] == 0
                                       for s in csum_sites),
         **{k: udp_rx_site[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "call_ms",
                                        "plain_call_ms")},
         "library_ms": None,
         "shape": f"udp_rx: {udp_rx_site['shape']}",
         "sites": csum_sites,
         "ms_per_batch": sum(s["ms"] for s in csum_sites),
         "plain_ms_per_batch": sum(s["plain_ms"] for s in csum_sites),
         "bound_ms_per_batch": sum(s["bound_ms"] for s in csum_sites),
         "launches_per_batch": launches["checksum16"] // batches_run},
        {"name": "rs_encode", "route": "cuda",
         "source": "src/repro_torch/csrc/rs_encode.cu",
         "replaces": "src/repro/kernels/rs_encode/kernel.py:38",
         "launches": launches["rs_encode"], "max_abs_err": err_r,
         "bit_identical_to_plain": err_r == 0,
         "ms": ms_r, "plain_ms": plain_r, "bound_ms": br, "bound_by": br_by,
         "library_ms": None, "call_ms": call_r, "plain_call_ms": call_plain_r,
         "shape": f"rs_serve: ({B}, 4096) of ({B}, {L}) -> ({B}, 1024)",
         "launches_per_batch": launches["rs_encode"] // batches_run},
    ]
    print(json.dumps(main_line))
    print(json.dumps({"app_group_launches": app_launches,
                      "seconds": time.time() - t_all}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
