#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``) and
     print each kernel instance's registers, static shared memory and
     spills from the build log (none allowed in the bf16 flash and the
     scan kernels, whose instances the log must name); the timed launches
     of those two add their registers and shared memory (static and
     dynamic) as the profiler's trace records them;
  3. hold each kernel against its plain PyTorch version on the card —
     checksum and RS bit for bit (checksum: B=512, L=4160 and odd widths,
     lengths 0, odd, L and > L, with and without the pseudo-header term,
     aligned and not; RS: the (k, p) sweep of the reference's kernel tests
     and 512 requests of 4 KiB), flash attention within 2e-5 (float32) /
     2e-2 (bf16) with TF32 off (qwen1.5-0.5b's prefill shapes, the
     reference's sweep, causal=False, the bf16 kernel's edges: S = 63..65,
     127, 333, a window edge inside a key tile, G = 2, 4, 8, hd 80
     bidirectional, hd 128, gemma3-12b's hd 256 with its window; strided
     views in float32 and bf16) — and time each at the main paths'
     shapes, flash beside ``scaled_dot_product_attention`` as a
     yardstick, with the card's clock and power sampled beside each time;
  4. the RS path: an ``rs_serve`` RPC stack (eth -> ip -> udp/rpc ->
     RS(8,2) -> udp -> ip -> eth) on B=512 frames of L=4160: one
     ``rx_tx``, then ``run_stream`` over N=32 batches under
     ``torch.cuda.set_sync_debug_mode("error")``, held equal to 32
     sequential ``rx_tx`` calls; every reply parsed with numpy, its
     checksums verified and its parity held against ``rs_encode_np``; the
     drop table held against the bad frames; kernel launches counted;
  5. the same frames through the port on the CPU (plain versions) at N=2,
     outputs and whole state held equal to the card's;
  6. the app-group path: ``udp_topology`` with the replicated RS app
     (L=4160), then echo at L=1536, the same way;
  7. the LM path at the full width of qwen1.5-0.5b (24 layers, bf16
     compute, seeded weights): two ``ServeEngine``s prefill 8 prompts of
     1..2000 tokens through the flash kernel (their caches must be equal),
     and an ``lm_serve`` + ``rs_serve`` stack streams N=32 batches of B=64
     mixed LM and RS requests (a duplicate, an unknown session and a
     truncated request in each; each 8th batch RS only) with no host sync,
     held equal to 32 sequential ``rx_tx`` calls; the tokens equal the
     second engine's steps exactly, the error replies, drop reasons and
     RS parity are right, and an RS-only batch leaves the tile state
     bit-unchanged; prefill logits through the kernel are held against
     the plain version; per-request latency, direct against
     host-mediated;
  8. the LM path at 2 layers of the full width in float32, on the card
     and on the CPU: tokens, replies and integer state equal, logits and
     cache within 1e-3;
  9. the Mamba path at the full width and depth of falcon-mamba-7b (64
     layers, bf16 compute, seeded weights), once the LM phases' memory is
     freed: the selective-scan kernel held against its plain version
     within 1e-4 (D=8192, N=16, B and C strided views, S from 1 to 2000,
     one short of, at and one past the kernel's 64-step chunk, decays
     spanning 1e-8..1, B=2, the carry test; TF32 off) and timed; two ``ServeEngine``s prefill
     8 prompts of 1..2000 tokens through the kernel (their caches must be
     equal, 64 launches a prefill) and decode 16 steps of every session
     with no host sync inside ``decode_step`` (their tokens must be equal);
     a 2-token prompt is refused as by the reference; prefill logits and
     state through the kernel are held against the plain version, and the
     kernel against the plain version on every layer's own inputs; decode
     and prefill profiles and the serving loop's busy share;
 10. the Mamba path at 2 layers of the full width in float32, on the card
     and on the CPU: tokens equal, logits and state within 1e-3.

Prints the kernels' line ``{"kernels": [...]}`` and the timing lines, then,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result
line, when CUDA is absent or the repository is not beside it.
"""
from __future__ import annotations

import gc
import json
import os
import re
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

# the LM serving path: qwen1.5-0.5b at full width (bf16 compute)
LM_ARCH = "qwen1.5-0.5b"
PROMPT_LENS = (1, 129, 777, 1000, 1031, 1536, 1999, 2000)   # one session each
LM_MAX_SEQ = 2048
LM_B, LM_L, LM_N = 64, 4160, 32     # frames per batch, width, batches
RS_ONLY_EVERY = 8                   # each 8th batch carries RS traffic only
LM_PORT = 9400
SESSION_BASE = 1000                 # client session ids 1000..1007
UNKNOWN_SESSION = 4242
LAT_WARMUP, LAT_REQUESTS = 8, 40    # host path steps every session: 48 fit
CPU_LM_LAYERS, CPU_LM_BATCHES = 2, RS_ONLY_EVERY   # one RS-only batch
FLASH_QWEN_S = (1, 129, 1000, 1536, 2000)
FLASH_EDGE_CASES = (  # (S, H, KV, hd, window, causal): the bf16 kernel's edges
    (63, 16, 16, 64, 0, True), (64, 16, 16, 64, 0, True),   # 64-row tiles
    (65, 16, 16, 64, 0, True), (127, 16, 16, 64, 0, True),
    (333, 16, 16, 64, 0, True),
    (333, 8, 4, 64, 100, True),        # a window edge inside a key tile
    (333, 16, 8, 64, 0, True), (333, 16, 4, 64, 0, True),   # G = 2, 4
    (333, 16, 2, 64, 0, True),                              # G = 8
    (333, 16, 16, 80, 0, False),       # hubert-xlarge: hd 80, bidirectional
    (333, 8, 2, 128, 0, True),         # hd 128
    (1100, 16, 8, 256, 1024, True))    # gemma3-12b: hd 256, its window
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LOGIT_TOL = 2e-2                    # of the largest logit (bf16)
BF16_PEAK = 989e12                  # H100 SXM dense bf16 (data sheet)

# the Mamba serving path: falcon-mamba-7b at full width and depth (bf16
# compute); prompts of 2 tokens are refused by the install (as in the
# reference), so the shortest are 1 and 3 = W-1
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_PROMPT_LENS = (1, 3, 129, 777, 1000, 1031, 1999, 2000)
MAMBA_MAX_SEQ = 2048
MAMBA_STEPS = 16                    # decode steps of all 8 sessions
SCAN_D, SCAN_N, SCAN_R = 8192, 16, 256      # falcon-mamba's scan widths
SCAN_CHUNK = 64                     # the kernel's timesteps per pass
SCAN_CASES = ((1, 1), (1, 3), (1, 129), (1, 777), (1, 1000), (1, 2000),
              (2, 129), (1, SCAN_CHUNK - 1), (1, SCAN_CHUNK),
              (1, SCAN_CHUNK + 1))  # (B, S) held against the plain version
SCAN_SPAN_CASES = ((1, 2000), (2, 333))   # decays spanning 1e-8..1
SCAN_TIMED_S = (1, 129, 1000, 2000)
SCAN_TOL = 1e-4                     # atol and rtol: tests/test_kernels.py:132
SCAN_OPS = 8                        # float32 operations per (t, d, n)
STATE_TOL = 1e-3                    # the scan on the path's own inputs
CPU_MAMBA_LAYERS = 2

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


PLACEHOLDER = "spin_kernel"          # the kernel of torch.cuda._sleep


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
        # the first few kernels of a window have been seen to go
        # unrecorded: placeholder kernels, left out below, take their place
        for _ in range(16):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count, top = 0.0, 0, []
    for e in prof.key_averages():
        if PLACEHOLDER in e.key:
            continue
        if only is None or only in e.key:
            total_us += e.self_device_time_total
            count += e.count
            top.append((e.self_device_time_total / 1e3 / iters, e.count
                        // iters, e.key[:70]))
    return total_us / 1e3 / iters, count / iters, sorted(top)[::-1][:8]


def kernel_ms(torch, fn, name, iters):
    """Device time of one launch of the kernel whose name holds ``name``,
    for an ``fn`` that launches it once: the profiler's mean over the
    launches it recorded.  On the card's machine the profiler has been
    seen to leave up to a third of a window's launches unrecorded, so a
    sum divided by the calls would read short; once it recorded none of
    a window's launches, so an empty window is taken again, up to three
    times.  Returns (ms, launches recorded per call)."""
    for _ in range(3):
        total, per_call, _ = device_ms(torch, fn, iters=iters, only=name)
        if per_call > 0:
            return total / per_call, per_call
    fail(f"the profiler recorded no {name} launch in three windows")


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def smi_clocks():
    """One sample of the card's SM clock, its maximum and the power draw,
    as ``nvidia-smi`` reports them: beside each timed phase, so that a
    time can be read against the clock it ran at."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "power.draw", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed ({out.returncode})"


def demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True)
    got = out.stdout.splitlines() if out.returncode == 0 else []
    return got if len(got) == len(names) else list(names)


def kernel_resources(log):
    """Per kernel instance of the build log (``-Xptxas -v``): its name,
    registers a thread, spill bytes and static shared memory."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": m.group(1), "registers": None,
                         "spill_bytes": 0, "static_smem": 0})
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(m.group(1)) if m else 0
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = re.sub(r"^void |\(.*", "", name.replace(
            "(anonymous namespace)::", ""))
    return rows


def launch_resources(torch, fn, name):
    """What the card's trace records of a launch of the kernel whose name
    holds ``name``, made by ``fn``: registers a thread, shared memory
    (static and dynamic, in bytes), grid and block, as the profiler's
    kernel events carry them (CUPTI's launch record).  The trace is
    written into the checkout's build directory and removed.  As in
    ``device_ms``, placeholder kernels open the window and a window that
    recorded no such launch is taken again, up to three times; None when
    none did."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"trace-{os.getpid()}.json"
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        try:
            events = json.loads(path.read_text()).get("traceEvents", [])
        finally:
            path.unlink(missing_ok=True)
        for e in events:
            args = e.get("args", {})
            if e.get("cat") == "kernel" and name in e.get("name", ""):
                return {"kernel": e["name"][:80],
                        "registers": args.get("registers per thread"),
                        "shared_memory_bytes": args.get("shared memory"),
                        "grid": args.get("grid"), "block": args.get("block")}
    return None


# ---------------------------------------------------------------------------
# flash attention: the kernel against its plain version


def flash_inputs(torch, rng, dev, dtype, B_, S, H, KV, hd):
    """Seeded q (B, S, KV, G, hd), k, v (B, S, KV, hd) on the card."""
    def one(shape):
        a = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)
    return (one((B_, S, KV, H // KV, hd)), one((B_, S, KV, hd)),
            one((B_, S, KV, hd)))


def flash_bound(torch, B_, S, H, KV, hd, dtype, causal=True, window=0):
    """Least time for the work: 4 * hd flops per unmasked (query, key)
    pair and head, q, k, v and o read or written once."""
    qp = np.arange(S)[:, None]
    kp = np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= (qp - kp) < window
    flops = 4 * hd * int(ok.sum()) * B_ * H
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = size * B_ * S * hd * (2 * H + 2 * KV)
    peak = BF16_PEAK if dtype == torch.bfloat16 else CORE_OPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def flash_phase(torch, dev, rng):
    """Hold the kernel against its plain version on the card at qwen's
    prefill shapes, the reference's sweep, causal=False and a strided view;
    time the kernel, the plain version and SDPA (a yardstick only) at
    qwen's shapes in bf16, the LM path's dtype."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_model_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[flash] TF32 off for float32 products (the plain version is "
          "full float32); tolerance 2e-5 (float32), 2e-2 (bfloat16), as "
          "tests/test_kernels.py:101")
    cases = []
    for dn in ("float32", "bfloat16"):
        for S in FLASH_QWEN_S:
            cases.append(("qwen", dn, 1, S, 16, 16, 64, 0, True))
        for S, hd, kv, g, w in ((256, 64, 2, 1, 0), (512, 128, 1, 4, 0),
                                (256, 64, 2, 2, 128), (512, 64, 4, 2, 64)):
            cases.append(("sweep", dn, 2, S, kv * g, kv, hd, w, True))
        cases.append(("bidirectional", dn, 2, 300, 4, 2, 64, 0, False))
        for S, H, KV, hd, w, causal in FLASH_EDGE_CASES:
            cases.append(("edge", dn, 1, S, H, KV, hd, w, causal))
    errs = {}
    for what, dn, B_, S, H, KV, hd, w, causal in cases:
        dt = getattr(torch, dn)
        q, k, v = flash_inputs(torch, rng, dev, dt, B_, S, H, KV, hd)
        got = flash_ops.flash_attention(q, k, v, causal=causal, window=w)
        want = attention_model_ref(q, k, v, causal=causal, window=w)
        err = (got.float() - want.float()).abs().max().item()
        check(err <= FLASH_TOL[dn], f"flash kernel != plain by {err} at "
              f"{what} {dn} B={B_} S={S} H={H} KV={KV} hd={hd} window={w} "
              f"causal={causal}")
        errs[(what, dn, S, H, KV, hd, w, causal)] = err
    wide = torch.from_numpy(rng.standard_normal(
        (1, 333, 4, 2, 128)).astype(np.float32)).to(dev)
    kv_ = torch.from_numpy(rng.standard_normal(
        (1, 333, 2, 4, 64)).astype(np.float32)).to(dev)
    q, k, v = wide[..., 64:], kv_[:, :, 0], kv_[:, :, 1]
    err = (flash_ops.flash_attention(q, k, v, window=100)
           - attention_model_ref(q, k, v, window=100)).abs().max().item()
    check(err <= FLASH_TOL["float32"], f"flash kernel != plain on a "
          f"strided model-layout view ({err})")
    # the same views of bf16 tensors: 16-byte aligned rows whose strides
    # are not the row width (the bf16 kernel's cp.async path); converted
    # before slicing, since converting a view makes a dense copy
    wide, kv_ = wide.bfloat16(), kv_.bfloat16()
    q, k, v = wide[..., 64:], kv_[:, :, 0], kv_[:, :, 1]
    check(q.stride(-2) != q.shape[-1] and k.stride(1) != k[0, 0].numel()
          and not any(t.is_contiguous() for t in (q, k, v)),
          "the strided bf16 views came out dense")
    err = (flash_ops.flash_attention(q, k, v, window=100).float()
           - attention_model_ref(q, k, v, window=100).float()
           ).abs().max().item()
    check(err <= FLASH_TOL["bfloat16"], f"flash kernel != plain on a "
          f"strided bf16 model-layout view ({err})")
    torch.cuda.synchronize()
    print(f"[flash] {len(cases) + 2} cases within tolerance of the plain "
          f"version; max error float32 "
          f"{max(e for c, e in errs.items() if c[1] == 'float32'):.3g}, "
          f"bfloat16 "
          f"{max(e for c, e in errs.items() if c[1] == 'bfloat16'):.3g}")

    sizes = []
    F_ = torch.nn.functional
    for S in FLASH_QWEN_S:
        dt = torch.bfloat16
        clocks = [smi_clocks()]
        q, k, v = flash_inputs(torch, rng, dev, dt, 1, S, 16, 16, 64)
        call = lambda: flash_ops.flash_attention(q, k, v)          # noqa
        plain = lambda: attention_model_ref(q, k, v)               # noqa
        qh, kh, vh = (t.reshape(1, S, 16, 64).transpose(1, 2)
                      for t in (q, k, v))
        lib = lambda: F_.scaled_dot_product_attention(             # noqa
            qh, kh, vh, is_causal=True)
        err = (call().float() - plain().float()).abs().max().item()
        lib_err = (call().float() - lib().transpose(1, 2).reshape(
            1, S, 16, 1, 64).float()).abs().max().item()
        ms, recorded = kernel_ms(torch, call, "flash", iters=20)
        p_ms, p_kernels, _ = device_ms(torch, plain, iters=5)
        l_ms, _, _ = device_ms(torch, lib, iters=20)
        b_ms, b_by = flash_bound(torch, 1, S, 16, 16, 64, dt)
        sizes.append({"S": S, "shape": f"q (1, {S}, 16, 1, 64) bf16, "
                      f"causal", "max_abs_err": err, "sdpa_max_abs_err":
                      lib_err, "ms": ms, "plain_ms": p_ms,
                      "plain_kernels": p_kernels, "library_ms": l_ms,
                      "profiler_launches_per_call": recorded,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "call_ms": time_cuda(torch, call, iters=20),
                      "clocks_sm_max_power": clocks + [smi_clocks()],
                      "launch": launch_resources(torch, call, "flash")})
        print(f"[flash] S={S} bf16: kernel {ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, SDPA {l_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
              f"err {err:.3g}; clocks.sm, max, power "
              f"{' -> '.join(sizes[-1]['clocks_sm_max_power'])}; launch "
              f"{sizes[-1]['launch']}")
    return {"cases": len(cases) + 2, "errs": errs, "sizes": sizes}


# ---------------------------------------------------------------------------
# LM serving: frames, reply checks, the path


def make_lm_batches(F, rpc, lm_server, rng, n_batches, batch, width,
                    sessions):
    """n_batches x batch frames.  Every batch but each 8th holds one
    MSG_LM_GENERATE for each session, a duplicate of one of them, one for
    an unknown session and a truncated one; RS requests of 4 KiB fill the
    rest (each 8th batch is RS only).  Rows are shuffled.  Returns
    (payload (n, B, L), length (n, B), rows [(kind, session)] per batch,
    blocks {(b, i): 4 KiB})."""
    payload = np.zeros((n_batches, batch, width), np.uint8)
    length = np.zeros((n_batches, batch), np.int32)
    kinds, blocks = [], {}
    for b in range(n_batches):
        rows = []
        if b % RS_ONLY_EVERY != RS_ONLY_EVERY - 1:
            rows += [("lm", s) for s in sessions]
            rows += [("lm_dup", sessions[b % len(sessions)]),
                     ("lm_unknown", UNKNOWN_SESSION),
                     ("lm_short", sessions[0])]
        rows += [("rs", None)] * (batch - len(rows))
        rows = [rows[j] for j in rng.permutation(batch)]
        for i, (kind, sess) in enumerate(rows):
            rid = b * batch + i
            if kind == "rs":
                blk = rng.integers(0, 256, 4096, dtype="uint8").tobytes()
                blocks[(b, i)] = blk
                body = rpc.np_frame(rpc.MSG_RS_ENCODE, rid, blk)
            else:
                req = lm_server.encode_request(sess, 1, [])
                if kind == "lm_short":
                    req = req[:5]
                body = rpc.np_frame(rpc.MSG_LM_GENERATE, rid, req)
            fr = F.udp_rpc_frame(IP_C, IP_S, 5000 + i % 64, LM_PORT, body)
            payload[b, i, :len(fr)] = memoryview(fr)
            length[b, i] = len(fr)
        kinds.append(rows)
    return payload, length, kinds, blocks


def reply_body(q, ql, what):
    """The RPC body of one reply frame, after checking its Ethernet type,
    IPv4 and UDP checksums and RPC magic with numpy."""
    ql = int(ql)
    check(ql >= 51 and q[12] == 0x08 and q[13] == 0, f"{what}: not IPv4")
    check(np_csum_ok(q[None, 14:34])[0], f"{what}: IP checksum")
    ulen = ql - 34
    pseudo = ((IP_S >> 16) + (IP_S & 0xFFFF) + (IP_C >> 16)
              + (IP_C & 0xFFFF) + 17 + ulen)
    check(np_csum_ok(q[None, 34:34 + ulen], np.uint64(pseudo))[0],
          f"{what}: UDP checksum")
    check(q[42] == 0xBE and q[43] == 0xE5, f"{what}: RPC magic")
    plen = (int(q[49]) << 8) | int(q[50])
    return bytes(q[51:51 + plen])


def tree_equal(torch, convert, a, b, what):
    """Two nests of tensors equal leaf for leaf (dtype and bits)."""
    fa, fb = convert.flatten(a), convert.flatten(b)
    check(fa.keys() == fb.keys(), f"{what}: keys {fa.keys() ^ fb.keys()}")
    for k in fa:
        check(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]),
              f"{what}: {k} differs")


class sync_errors:
    """torch.cuda.set_sync_debug_mode("error") on the card (a host sync
    raises), nothing on the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.on = torch, dev.type == "cuda"

    def __enter__(self):
        if self.on:
            self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.set_sync_debug_mode("default")


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def lm_path(torch, dev, cfg, params, prompt_lens, max_seq, batch, width,
            n_batches, seed):
    """The LM serving path: two engines prefill the same prompts (through
    the flash kernel on the card), the tile state adopts the first, and an
    ``lm_serve`` + ``rs_serve`` RPC stack streams ``n_batches`` batches of
    mixed LM and RS requests with no host sync, held equal to sequential
    ``rx_tx`` calls.  Returns what the checks and timings need."""
    from repro_torch import convert
    from repro_torch.apps import lm_server
    from repro_torch.kernels.checksum import ops as csum_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rs_encode import gf
    from repro_torch.kernels.rs_encode import ops as rs_ops
    from repro_torch.kernels.rs_encode.ref import rs_encode_np
    from repro_torch.models import model as TM
    from repro_torch.net import frames as F, rpc
    from repro_torch.net.stack import UdpStack, rpc_serve_topology
    from repro_torch.obs import reasons as R
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in prompt_lens]
    sessions = [SESSION_BASE + i for i in range(len(prompts))]
    M = len(prompts)
    frames_p, frames_l, kinds, blocks = make_lm_batches(
        F, rpc, lm_server, rng, n_batches, batch, width, sessions)
    arena_p = torch.from_numpy(frames_p).to(dev)
    arena_l = torch.from_numpy(frames_l).to(dev)
    lm = lm_server.make_tile(cfg, params, max_sessions=M, max_seq=max_seq)
    stack = UdpStack([lm], IP_S, device=dev, topo=rpc_serve_topology(
        [("lm", "lm_serve", rpc.MSG_LM_GENERATE),
         ("rs", "rs_serve", rpc.MSG_RS_ENCODE)]))
    order = stack.pipeline.order
    sync(torch, dev)

    # ---- the counted run: prefill twice, stream, sequential rx_tx --------
    csum_ops.checksum16.launches = 0
    rs_ops.encode_blocks.launches = 0
    flash_ops.flash_attention.launches = 0
    engines, smaps = [], []
    for _ in range(2):
        eng = ServeEngine(cfg, params, max_sessions=M, max_seq=max_seq)
        smaps.append({s: eng.new_session(pr)
                      for s, pr in zip(sessions, prompts)})
        engines.append(eng)
    eng_a, eng_b = engines
    tree_equal(torch, convert, eng_a.cache, eng_b.cache,
               "two engines' prefill caches of the same prompts")
    check(torch.equal(eng_a.last_tok, eng_b.last_tok)
          and torch.equal(eng_a.pos, eng_b.pos),
          "two engines' first tokens or positions")
    st_stream = stack.init_state()
    st_stream["apps"]["lm"] = lm_server.adopt_engine(
        st_stream["apps"]["lm"], eng_a, smaps[0])
    st_seq = stack.init_state()
    st_seq["apps"]["lm"] = lm_server.adopt_engine(
        st_seq["apps"]["lm"], eng_a, smaps[0])
    rs_only = [b for b in range(n_batches)
               if all(k == "rs" for k, _ in kinds[b])]
    snap_b = rs_only[0]
    sync(torch, dev)
    with sync_errors(torch, dev):
        st_stream, outs = stack.run_stream(st_stream, arena_p, arena_l)
        seq, snaps = [], {}
        for b in range(n_batches):
            if b == snap_b:
                snaps["before"] = {k: t.clone() for k, t in convert.flatten(
                    st_seq["apps"]["lm"]).items()}
            st_seq, q, ql, al, inf = stack.rx_tx(st_seq, arena_p[b],
                                                 arena_l[b])
            seq.append((q, ql, al, inf["lm"], inf["rs"],
                        st_seq["apps"]["lm"]["last_tok"]))
            if b == snap_b:
                snaps["after"] = {k: t.clone() for k, t in convert.flatten(
                    st_seq["apps"]["lm"]).items()}
    sync(torch, dev)
    launches = {"flash_attention": flash_ops.flash_attention.launches,
                "checksum16": csum_ops.checksum16.launches,
                "rs_encode": rs_ops.encode_blocks.launches}
    # on the card: each prefill runs the kernel once a layer; each batch,
    # streamed and sequential, four checksums and one RS encode
    on = int(dev.type == "cuda")
    check(launches == {"flash_attention": on * 2 * M * cfg.n_layers,
                       "checksum16": on * 8 * n_batches,
                       "rs_encode": on * 2 * n_batches},
          f"launches on the LM path: {launches}")

    # ---- stream == sequential; the RS-only batch left the cache alone ----
    for b in range(n_batches):
        q, ql, al, i_lm, i_rs, _ = seq[b]
        check(torch.equal(q, outs["tx_payload"][b])
              and torch.equal(ql, outs["tx_len"][b])
              and torch.equal(al, outs["alive"][b])
              and torch.equal(i_lm, outs["info"]["lm"][b])
              and torch.equal(i_rs, outs["info"]["rs"][b]),
              f"LM stream batch {b} != sequential rx_tx")
    tree_equal(torch, convert, st_stream, st_seq,
               "LM stream state vs sequential rx_tx")
    tree_equal(torch, convert, snaps["before"], snaps["after"],
               f"tile state across the RS-only batch {snap_b}")

    # ---- replies --------------------------------------------------------
    tx = outs["tx_payload"].cpu().numpy()
    txl = outs["tx_len"].cpu().numpy()
    alive = outs["alive"].cpu().numpy()
    i_lm = outs["info"]["lm"].cpu().numpy()
    i_rs = outs["info"]["rs"].cpu().numpy()
    check(alive.all(), "a frame of the LM stream was dropped")
    tokens = {s: [] for s in sessions}
    rs_rows = []
    n_lm = 0
    for b in range(n_batches):
        by_session = {}
        lm_batch = False
        for i, (kind, sess) in enumerate(kinds[b]):
            check(bool(i_lm[b, i]) == (kind != "rs")
                  and bool(i_rs[b, i]) == (kind == "rs"),
                  f"batch {b} row {i}: dispatched to the wrong tile")
            if kind == "rs":
                rs_rows.append((b, i))
                continue
            body = reply_body(tx[b, i], txl[b, i], f"LM reply {(b, i)}")
            if kind == "lm":
                lm_batch = True
                sid, toks, ok = lm_server.decode_reply(body)
                check(ok and sid == sess and len(toks) == 1
                      and lm_server.reply_error(body) is None,
                      f"LM reply {(b, i)}: {body.hex()}")
                tokens[sess].append(toks[0])
                by_session[sess] = body
        for i, (kind, sess) in enumerate(kinds[b]):
            if kind in ("rs", "lm"):
                continue
            body = reply_body(tx[b, i], txl[b, i], f"LM reply {(b, i)}")
            want = {"lm_dup": None, "lm_unknown": lm_server.ERR_NO_SESSION,
                    "lm_short": lm_server.ERR_BAD_REQUEST}[kind]
            if kind == "lm_dup":
                check(body == by_session[sess], f"duplicate {(b, i)} was "
                      f"not coalesced")
            else:
                check(lm_server.reply_error(body) == want,
                      f"{kind} {(b, i)}: reply {body.hex()}")
        n_lm += lm_batch
    check_replies(gf, rs_encode_np, tx, txl, rs_rows, blocks, 1024,
                  "rs_serve beside lm_serve")
    # the engine's tokens: the replies carry their low 16 bits (the wire's
    # u16), the tile's state the whole id after every LM batch
    full = [seq[b][5].cpu().numpy() for b in range(n_batches)
            if b not in rs_only]
    want_toks = {s: [] for s in sessions}
    for k in range(n_lm):
        row = eng_b.step()
        check(np.array_equal(full[k], row), f"tile last_tok after LM batch "
              f"{k} != ServeEngine.step: {full[k]} vs {row}")
        for s in sessions:
            want_toks[s].append(int(row[smaps[1][s]]) & 0xFFFF)
    bad = [(s, k, tokens[s][k], want_toks[s][k]) for s in sessions
           for k in range(n_lm) if tokens[s][k] != want_toks[s][k]]
    check(not bad, f"LM stream tokens != ServeEngine.step tokens at "
          f"{len(bad)} of {n_lm * M} (session, step, stream, engine): "
          f"{bad[:8]}")
    wide = sum(int((f >= 1 << 16).sum()) for f in full)
    st = st_stream["apps"]["lm"]
    check(st["pos"].cpu().tolist() == [n + n_lm for n in prompt_lens],
          "session positions after the stream")
    check(int(st["served"]) == n_lm * (M + 1), "served counter")
    drops = st_stream["telemetry"]["drops"].cpu().numpy()
    li = order.index("lm")
    check(drops[li, R.APP_NO_SESSION] == n_lm
          and drops[li, R.APP_BAD_REQ] == n_lm
          and drops[li].sum() == 2 * n_lm, f"lm drop row {drops[li]}")
    print(f"[lm] {n_batches} batches of {batch} (L={width}) streamed with "
          f"no host sync == sequential rx_tx; {sum(map(len, tokens.values()))}"
          f" tokens == ServeEngine.step over {n_lm} steps ({wide} above "
          f"0xFFFF: replies carry the low 16 bits, the tile state the id); "
          f"{len(rs_rows)} RS replies checked; error replies and drop "
          f"reasons right; tile state unchanged across RS-only batch "
          f"{snap_b}; launches {launches}")
    return {"stack": stack, "eng_a": eng_a,
            "smap": smaps[0], "sessions": sessions, "prompts": prompts,
            "arena": (arena_p, arena_l), "kinds": kinds, "n_lm": n_lm,
            "launches": launches, "tokens": tokens, "outs": outs,
            "tokens_above_u16": wide,
            "state": st_stream}


def prefill_logits_check(torch, dev, cfg, params, prompts):
    """Last-token prefill logits through the kernel against the plain
    version, on the card.  Tolerance: 2e-2 of the largest logit — the
    bf16 tolerance of the reference's kernel test taken on the logits'
    scale, since the two attentions differ by float32 rounding that each
    layer's bf16 output may round to a neighbouring value; greedy tokens
    must agree wherever the top-2 margin exceeds twice that."""
    import types
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_model_ref
    from repro_torch.models import layers as TL
    from repro_torch.models import model as TM
    out = []
    for pr in prompts:
        tok = torch.from_numpy(pr[None]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lk, _ = TM.prefill(cfg, params, {"tokens": tok})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        TL.flash_ops = types.SimpleNamespace(
            flash_attention=attention_model_ref)
        try:
            lp, _ = TM.prefill(cfg, params, {"tokens": tok})
        finally:
            TL.flash_ops = flash_ops
        lk, lp = lk.float()[0], lp.float()[0]
        check(bool(torch.isfinite(lk).all()), f"non-finite logits at "
              f"prompt length {len(pr)}")
        scale = lp[:cfg.vocab].abs().max().item()
        err = (lk - lp)[:cfg.vocab].abs().max().item()
        tol = LOGIT_TOL * scale
        check(err <= tol, f"prefill logits kernel vs plain: {err} > {tol} "
              f"at prompt length {len(pr)}")
        top2 = lp[:cfg.vocab].topk(2).values
        margin = (top2[0] - top2[1]).item()
        same = int(lk[:cfg.vocab].argmax()) == int(lp[:cfg.vocab].argmax())
        check(same or margin <= 2 * tol, f"greedy token differs with a "
              f"margin of {margin} at prompt length {len(pr)}")
        out.append({"S": len(pr), "prefill_ms": ms, "max_abs_err": err,
                    "scale": scale,
                    "tol": tol, "top2_margin": margin,
                    "greedy_equal": same})
    print(f"[lm] prefill logits, kernel vs plain: max error "
          f"{max(o['max_abs_err'] for o in out):.4g} (tolerance "
          f"{LOGIT_TOL} x max |logit|); greedy equal "
          f"{sum(o['greedy_equal'] for o in out)}/{len(out)}")
    return out


def lm_profile(torch, cfg, params, lm):
    """Where a step's time goes: one decode step of the 8 sessions (on a
    copy of the first engine's cache), host clock and device time with
    its largest events; and each prefill's device time with the flash
    kernel's share."""
    from repro_torch.models import model as TM
    from repro_torch.tree import tree_map
    eng = lm["eng_a"]
    cache = tree_map(torch.clone, eng.cache)

    def step():
        TM.decode_step(cfg, params, cache, eng.last_tok, eng.pos)

    step()
    torch.cuda.synchronize()
    clocks = [smi_clocks()]
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    d_ms, d_events, d_top = device_ms(torch, step, iters=3)
    clocks.append(smi_clocks())
    prefill = {}
    for pr in lm["prompts"]:
        tok = torch.from_numpy(pr[None]).to(eng.device)
        fn = lambda: TM.prefill(cfg, params, {"tokens": tok})     # noqa
        p_ms, p_events, _ = device_ms(torch, fn, iters=1)
        f_ms, _, _ = device_ms(torch, fn, iters=1, only="flash")
        prefill[len(pr)] = {"device_ms": p_ms, "flash_ms": f_ms,
                            "device_events": p_events}
    out = {"decode_wall_ms": float(np.median(walls)),
           "decode_wall_samples": walls, "decode_device_ms": d_ms,
           "decode_device_events": d_events, "decode_top": d_top,
           "decode_clocks_sm_max_power": clocks, "prefill_device": prefill}
    print(f"[lm] decode step of {eng.M} sessions: {out['decode_wall_ms']:.2f}"
          f" ms wall, {d_ms:.2f} ms device from {d_events:.0f} events; "
          f"prefill at {len(lm['prompts'][-1])} tokens: "
          f"{prefill[len(lm['prompts'][-1])]['device_ms']:.2f} ms device, "
          f"flash {prefill[len(lm['prompts'][-1])]['flash_ms']:.2f} ms; "
          f"decode clocks.sm, max, power {' -> '.join(clocks)}")
    return out


def lm_timing(torch, dev, lm):
    """Streamed ms per batch (host clock around synchronized work) and the
    card's busy share over one stream (profiler device time / wall)."""
    from repro_torch.apps import lm_server
    stack, eng_a = lm["stack"], lm["eng_a"]
    arena_p, arena_l = lm["arena"]
    n = arena_p.shape[0]

    def fresh():
        st = stack.init_state()
        st["apps"]["lm"] = lm_server.adopt_engine(st["apps"]["lm"], eng_a,
                                                  lm["smap"])
        torch.cuda.synchronize()
        return st

    samples = []
    for _ in range(2):
        st = fresh()
        t0 = time.perf_counter()
        stack.run_stream(st, arena_p, arena_l)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    st = fresh()
    dev_ms, dev_kernels, top = device_ms(
        torch, lambda: stack.run_stream(st, arena_p, arena_l), iters=1)
    stream_ms = float(np.median(samples))
    return {"stream_ms_samples": samples, "stream_ms_total": stream_ms,
            "stream_ms_per_batch": stream_ms / n, "device_ms": dev_ms,
            "device_kernels": dev_kernels, "busy_share": dev_ms / stream_ms,
            "top": top}


def lm_latency(torch, dev, lm):
    """Per-request latency, direct (one-frame ``run_stream`` windows: parse,
    one decode step on the card, reply framed, all without the host)
    against host-mediated (the card parses, the host syncs the body out,
    ``LmServerApp.handle`` drives the engine, the host frames the reply),
    round robin over the same sessions — the paper's comparison."""
    from repro_torch.apps import lm_server
    from repro_torch.net import eth, frames as F, ipv4, rpc, udp
    stack, eng_a, smap = lm["stack"], lm["eng_a"], lm["smap"]
    sessions = lm["sessions"]
    n = LAT_WARMUP + LAT_REQUESTS
    frames = [F.udp_rpc_frame(IP_C, IP_S, 5000 + i % 64, LM_PORT,
                              rpc.np_frame(rpc.MSG_LM_GENERATE, i,
                                           lm_server.encode_request(
                                               sessions[i % len(sessions)],
                                               1, [])))
              for i in range(n)]
    width = max(len(f) for f in frames) + 8
    windows = []
    for f in frames:
        p, l = F.to_batch([f], width)
        windows.append((torch.from_numpy(p)[None].to(dev),
                        torch.from_numpy(l)[None].to(dev)))
    st = stack.init_state()
    st["apps"]["lm"] = lm_server.adopt_engine(st["apps"]["lm"], eng_a, smap)
    sync(torch, dev)
    lat_d, direct_tok = [], []
    for i, (p, l) in enumerate(windows):
        t0 = time.perf_counter()
        st, outs = stack.run_stream(st, p, l)
        sync(torch, dev)
        dt = (time.perf_counter() - t0) * 1e6
        body = reply_body(outs["tx_payload"][0, 0].cpu().numpy(),
                          outs["tx_len"][0, 0].item(), f"direct {i}")
        sid, toks, ok = lm_server.decode_reply(body)
        check(ok and len(toks) == 1, f"direct request {i} not served")
        direct_tok.append(toks[0])
        if i >= LAT_WARMUP:
            lat_d.append(dt)

    def parse_rx(payload, length):
        pp, ll, m = eth.parse(payload, length)
        pp, ll, m2, ok1 = ipv4.parse(pp, ll)
        m.update(m2)
        pp, ll, m3, ok2 = udp.parse(pp, ll, m)
        body, blen, _, ok3 = rpc.parse(pp, ll)
        return body, blen, ok1 & ok2 & ok3

    app = lm_server.LmServerApp(eng_a)
    for s, sid in smap.items():
        app.session_map[s] = sid
    lat_h = []
    for i, (p, l) in enumerate(windows):
        t0 = time.perf_counter()
        body, blen, ok = parse_rx(p[0], l[0])
        req = bytes(body[0, :int(blen[0])].cpu().numpy().tobytes())
        reply = app.handle(req)
        F.udp_rpc_frame(IP_S, IP_C, LM_PORT, 5000,
                        rpc.np_frame(rpc.MSG_LM_GENERATE, i, reply))
        dt = (time.perf_counter() - t0) * 1e6
        check(bool(ok[0]) and lm_server.reply_error(reply) is None,
              f"host-mediated request {i} failed")
        if i >= LAT_WARMUP:
            lat_h.append(dt)

    def pct(x):
        p50, p99 = np.percentile(x, [50.0, 99.0])
        return {"n": len(x), "p50_us": float(p50), "p99_us": float(p99),
                "mean_us": float(np.mean(x)), "max_us": float(np.max(x))}
    d, h = pct(lat_d), pct(lat_h)
    print(f"[lm] per-request latency over {LAT_REQUESTS} requests: direct "
          f"p50 {d['p50_us']:.0f} us p99 {d['p99_us']:.0f} us; "
          f"host-mediated p50 {h['p50_us']:.0f} us p99 {h['p99_us']:.0f} us")
    return {"direct": d, "host": h,
            "speedup_p50": h["p50_us"] / d["p50_us"],
            "speedup_p99": h["p99_us"] / d["p99_us"]}


def lm_cpu_check(torch, dev, cfg, seed):
    """The LM path at CPU_LM_LAYERS layers of the full width in float32,
    on the card and on the CPU (plain versions): prefill logits within
    1e-3 (float32 everywhere, TF32 off, sums in another order; the kernel
    alone is held to 2e-5) and the streamed replies, masks and integer
    tile state equal, the cache within 1e-3."""
    import copy
    import dataclasses
    from repro_torch import convert
    from repro_torch.models import model as TM
    cfg2 = dataclasses.replace(cfg, n_layers=CPU_LM_LAYERS,
                               compute_dtype="float32")
    cpu = torch.device("cpu")
    params_g = TM.init_params(cfg2, seed=seed, device=dev)
    params_c = copy.deepcopy(params_g).to(cpu)
    g, c = (lm_path(torch, d, cfg2, p, PROMPT_LENS, LM_MAX_SEQ, LM_B, LM_L,
                    CPU_LM_BATCHES, seed)
            for d, p in ((dev, params_g), (cpu, params_c)))
    check(g["tokens"] == c["tokens"], "CPU tokens != card tokens")
    for k in ("tx_payload", "tx_len", "alive"):
        check(torch.equal(g["outs"][k].cpu(), c["outs"][k]),
              f"CPU LM stream {k} != card")
    fg = convert.flatten(convert.state_to_numpy(g["state"]))
    fc = convert.flatten(convert.state_to_numpy(c["state"]))
    check(fg.keys() == fc.keys(), "CPU state keys != card")
    cache_err = 0.0
    for k in fg:
        if "/cache/" in k:
            cache_err = max(cache_err, float(np.abs(fg[k] - fc[k]).max()))
        else:
            check(np.array_equal(fg[k], fc[k]), f"CPU state {k} != card")
    check(cache_err <= 1e-3, f"CPU cache differs from the card's by "
          f"{cache_err}")
    logit_err = 0.0
    for pr in g["prompts"]:
        lg, _ = TM.prefill(cfg2, params_g,
                           {"tokens": torch.from_numpy(pr[None]).to(dev)})
        lc, _ = TM.prefill(cfg2, params_c,
                           {"tokens": torch.from_numpy(pr[None])})
        logit_err = max(logit_err, (lg.cpu() - lc).abs().max().item())
    check(logit_err <= 1e-3, f"CPU prefill logits differ by {logit_err}")
    print(f"[cpu] LM path at {CPU_LM_LAYERS} layers of the full width, "
          f"float32: CPU tokens, replies and tile state == card; cache "
          f"error {cache_err:.3g}, prefill logit error {logit_err:.3g}")
    return {"layers": CPU_LM_LAYERS, "batches": CPU_LM_BATCHES,
            "cache_max_abs_err": cache_err,
            "prefill_logit_max_abs_err": logit_err}


# ---------------------------------------------------------------------------
# the Mamba selective scan: the kernel against its plain version


def scan_inputs(torch, rng, dev, B_, S, span=False):
    """Seeded inputs at falcon-mamba's scan widths, as its prefill makes
    them: u normal, dt a softplus of a normal shifted by -1, B and C
    strided column views of one (B, S, dt_rank + 2N) tensor (the model's
    ``x_proj`` output), A = -(1..N) on every channel (the model's init).
    ``span``: dt log-uniform in [1e-6, 1.15] instead, so that the decays
    exp(dt A) span ~1e-8 to ~1 (a carry that vanishes within a step, one
    that survives the whole sequence)."""
    def dev_f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)
    u = dev_f32(rng.standard_normal((B_, S, SCAN_D)))
    if span:
        dt = dev_f32(np.exp(rng.uniform(np.log(1e-6), np.log(1.15),
                                        (B_, S, SCAN_D))))
    else:
        dt = dev_f32(np.log1p(np.exp(rng.standard_normal((B_, S, SCAN_D))
                                     - 1.0)))
    dbc = dev_f32(rng.standard_normal((B_, S, SCAN_R + 2 * SCAN_N)))
    _, bm, cm = dbc.split([SCAN_R, SCAN_N, SCAN_N], dim=-1)
    A = -torch.arange(1, SCAN_N + 1, dtype=torch.float32,
                      device=dev).repeat(SCAN_D, 1)
    return u, dt, bm, cm, A


def scan_bound(B_, S, D, N):
    """Least time for the scan: u, dt and y (B, S, D), B and C (B, S, N),
    A and h_last each read or written once; SCAN_OPS float32 operations
    per (t, d, n) on the CUDA cores."""
    nbytes = 4 * (3 * B_ * S * D + 2 * B_ * S * N + D * N + B_ * D * N)
    return bound_ms(nbytes, SCAN_OPS * B_ * S * D * N)


def allclose_err(got, want, tol):
    """(max |got - want|, whether every element is within tol + tol *
    |want|, numpy's allclose with atol = rtol = tol)."""
    d = (got - want).abs()
    return d.max().item(), bool((d <= tol + tol * want.abs()).all())


def scan_phase(torch, dev, rng):
    """Hold the kernel against its plain version on the card at
    falcon-mamba's widths (D = 8192, N = 16, B and C strided views) for
    the prompt lengths of the path, B = 2, and the reference's carry test;
    time the kernel at S = 1, 129, 1000, 2000 and the plain version at
    2000."""
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for B_, S, span in ([(b_, s_, False) for b_, s_ in SCAN_CASES]
                        + [(b_, s_, True) for b_, s_ in SCAN_SPAN_CASES]):
        args = scan_inputs(torch, rng, dev, B_, S, span)
        y, h = scan_ops.mamba_scan(*args)
        wy, wh = mamba_scan_ref(*args)
        ey, ok_y = allclose_err(y, wy, SCAN_TOL)
        eh, ok_h = allclose_err(h, wh, SCAN_TOL)
        check(ok_y and ok_h and bool(torch.isfinite(y).all()),
              f"mamba_scan kernel != plain at B={B_} S={S} span={span}: "
              f"y {ey}, h_last {eh} (tolerance {SCAN_TOL})")
        cases.append({"B": B_, "S": S, "decay_span": span,
                      "y_max_abs_err": ey, "h_max_abs_err": eh})
    # u and dt as views that are not 16-byte aligned: the kernel copies
    # them element by element instead of in 16-byte groups
    B_, S = 1, 333
    u, dt, bm, cm, A = scan_inputs(torch, rng, dev, B_, S)
    wide = torch.cat([u, dt, dt[..., :2]], dim=-1)    # (1, S, 2D + 2)
    u_, dt_ = wide[..., 1:SCAN_D + 1], wide[..., SCAN_D + 1:2 * SCAN_D + 1]
    y, h = scan_ops.mamba_scan(u_, dt_, bm, cm, A)
    wy, wh = mamba_scan_ref(u_, dt_, bm, cm, A)
    ey, ok_y = allclose_err(y, wy, SCAN_TOL)
    eh, ok_h = allclose_err(h, wh, SCAN_TOL)
    check(ok_y and ok_h, f"mamba_scan kernel != plain on misaligned u, dt "
          f"views: y {ey}, h_last {eh} (tolerance {SCAN_TOL})")
    cases.append({"B": B_, "S": S, "decay_span": False,
                  "misaligned_u_dt": True, "y_max_abs_err": ey,
                  "h_max_abs_err": eh})
    # the reference's carry test (tests/test_kernels.py:138-151): decay ~1
    # and constant input, so y grows linearly over the whole sequence
    B_, S, D, N = 1, 512, 32, 4
    y, _ = scan_ops.mamba_scan(
        torch.ones((B_, S, D), device=dev),
        torch.full((B_, S, D), 1e-3, device=dev),
        torch.ones((B_, S, N), device=dev), torch.ones((B_, S, N), device=dev),
        torch.full((D, N), -1e-6, device=dev))
    yt = y[0, :, 0].cpu().numpy()
    check((np.diff(yt) > 0).all()
          and abs(yt[-1] / yt[127] - S / 128.0) <= 1e-2 * S / 128.0,
          "mamba_scan kernel: the state does not carry across the sequence")
    torch.cuda.synchronize()
    err = max(max(c["y_max_abs_err"], c["h_max_abs_err"]) for c in cases)
    print(f"[scan] {len(cases) + 1} cases (D={SCAN_D}, N={SCAN_N}, B and C "
          f"strided, the carry test) within {SCAN_TOL} of the plain version "
          f"(TF32 off); max error {err:.3g}")

    sizes = []
    for S in SCAN_TIMED_S:
        clocks = [smi_clocks()]
        args = scan_inputs(torch, rng, dev, 1, S)
        call = lambda: scan_ops.mamba_scan(*args)                  # noqa
        ms, per_call = kernel_ms(torch, call, "mamba_scan", iters=20)
        b_ms, b_by = scan_bound(1, S, SCAN_D, SCAN_N)
        row = {"S": S, "shape": f"u, dt (1, {S}, {SCAN_D}); B, C (1, {S}, "
               f"{SCAN_N}) strided views of (1, {S}, "
               f"{SCAN_R + 2 * SCAN_N}); float32", "ms": ms,
               "profiler_launches_per_call": per_call,
               "bound_ms": b_ms, "bound_by": b_by,
               "call_ms": time_cuda(torch, call, iters=20),
               "clocks_sm_max_power": clocks + [smi_clocks()],
               "launch": launch_resources(torch, call, "mamba_scan")}
        if S == SCAN_TIMED_S[-1]:
            plain = lambda: mamba_scan_ref(*args)                  # noqa
            row["plain_ms"], row["plain_kernels"], _ = device_ms(
                torch, plain, iters=1)
        sizes.append(row)
        print(f"[scan] S={S}: kernel {ms:.4f} ms ({per_call:.2f} recorded "
              f"a call; call {row['call_ms']:.4f}), bound {b_ms:.5f} ms "
              f"({b_by})" + (f", plain {row['plain_ms']:.3f} ms "
                             f"({row['plain_kernels']:.0f} kernels)"
                             if "plain_ms" in row else "")
              + f"; clocks.sm, max, power "
              f"{' -> '.join(row['clocks_sm_max_power'])}; launch "
              f"{row['launch']}")
    return {"cases": cases, "max_abs_err": err, "sizes": sizes}


# ---------------------------------------------------------------------------
# Mamba serving: the path, its checks and its profile


def mamba_path(torch, dev, cfg, params, prompt_lens, n_steps, n_engines,
               seed):
    """The Mamba serving path: ``n_engines`` ``ServeEngine``s prefill the
    same prompts (the scan on the kernel on the card), their caches must be
    equal; then each decodes ``n_steps`` steps of every session with
    ``model.decode_step`` under ``set_sync_debug_mode("error")`` (the host
    read that ends ``ServeEngine.step`` stays outside), and their tokens
    must be equal.  A 2-token prompt must be refused as the reference
    refuses it.  Returns what the checks and timings need."""
    from repro_torch import convert
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.models import model as TM
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in prompt_lens]
    M = len(prompts)
    real_prefill, real_decode = TM.prefill, TM.decode_step
    logits = []

    def prefill(*a, **k):            # keeps each prefill's last logits
        lg, cache = real_prefill(*a, **k)
        logits.append(lg.float()[0].clone())
        return lg, cache

    def decode_step(*a, **k):        # a host sync inside the step raises
        with sync_errors(torch, dev):
            return real_decode(*a, **k)

    def snapshot(eng):
        return {k: t.clone() for k, t in convert.flatten(eng.cache).items()}

    sync(torch, dev)
    scan_ops.mamba_scan.launches = 0
    TM.prefill, TM.decode_step = prefill, decode_step
    try:
        engines = []
        for _ in range(n_engines):
            eng = ServeEngine(cfg, params, max_sessions=M,
                              max_seq=MAMBA_MAX_SEQ)
            sids = [eng.new_session(pr) for pr in prompts]
            check(sids == list(range(M)), f"session ids {sids}")
            engines.append(eng)
        sync(torch, dev)
        launches = scan_ops.mamba_scan.launches
        after_prefill = snapshot(engines[0])
        tokens = [np.stack([eng.step() for _ in range(n_steps)])
                  for eng in engines]
        sync(torch, dev)
    finally:
        TM.prefill, TM.decode_step = real_prefill, real_decode
    on = int(dev.type == "cuda")
    check(launches == on * n_engines * M * cfg.n_layers,
          f"mamba_scan launches {launches} != {cfg.n_layers} per prefill")
    for eng in engines[1:]:
        tree_equal(torch, convert, engines[0].cache, eng.cache,
                   "two engines' states after the same prefills and steps")
        check(np.array_equal(tokens[0], tokens[-1]), "two engines' tokens")
        check(torch.equal(engines[0].last_tok, eng.last_tok)
              and torch.equal(engines[0].pos, eng.pos),
              "two engines' last tokens or positions")
    check(engines[0].pos.cpu().tolist() == [n + n_steps for n in prompt_lens],
          "session positions after decoding")

    # a prompt of 2 tokens: its conv state (2 rows) does not broadcast into
    # the slot's W-1 = 3, and the reference's install raises there too
    spare = ServeEngine(cfg, params, max_sessions=1, max_seq=MAMBA_MAX_SEQ)
    try:
        spare.new_session(prompts[-1][:2])
    except ValueError as e:
        refused = str(e)
    else:
        fail("a 2-token prompt was installed; the reference refuses it")
    check("installs only when it has 1 token" in refused
          and not spare.used.any(), f"2-token prompt: {refused}")
    del spare
    print(f"[mamba] {n_engines} engines x {M} sessions (prompts "
          f"{list(prompt_lens)}): caches equal, {n_steps} decode steps with "
          f"no host sync inside decode_step, tokens equal; a 2-token prompt "
          f"refused as by the reference; launches {launches}")
    return {"engines": engines, "prompts": prompts, "launches": launches,
            "tokens": tokens[0], "logits": logits[:M],
            "after_prefill": after_prefill, "after_decode":
            snapshot(engines[0]), "two_token_prompt": refused}


def mamba_logits_check(torch, dev, cfg, params, prompts):
    """For each prompt, on the card, at full depth:
    - prefill through the kernel in bf16 (host clock, synchronized): the
      path's prefill time;
    - prefill in bf16 with the plain version run beside the kernel at every
      layer, on that layer's own inputs: y and h_last within STATE_TOL;
    - prefill in float32 through the kernel and through the plain version:
      last-token logits within LOGIT_TOL of the largest logit, the cache's
      h within LOGIT_TOL of its largest entry;
    - prefill in bf16 through the plain version: the logits' and h's
      differences from the kernel's are recorded, and not held to a
      tolerance.  Across 64 bf16 layers the two scans' float32 rounding
      (1e-5) flips single bf16 roundings, and the later layers carry them
      on: on an H100 a 129-token prompt differed by 0.16 at a largest logit
      of 4.19, five bf16 units, while on identical inputs the two agree
      within 1.2e-5."""
    import dataclasses
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
    from repro_torch.models import blocks as TB
    from repro_torch.models import model as TM
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain_ops = types.SimpleNamespace(mamba_scan=mamba_scan_ref)

    def prefill(c, tok, ops=None):
        TB.scan_ops = ops or scan_ops
        try:
            lg, cache = TM.prefill(c, params, {"tokens": tok})
        finally:
            TB.scan_ops = scan_ops
        return lg.float()[0, :cfg.vocab], cache["units"]["p0"]["h"]

    def diff(a, b):
        return (a - b).abs().max().item(), b.abs().max().item()

    out = []
    for pr in prompts:
        tok = torch.from_numpy(pr[None]).to(dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        lk, hk = prefill(cfg, tok)
        sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(lk).all()), f"non-finite logits at "
              f"prompt length {len(pr)}")
        layer = {"y": 0.0, "h": 0.0, "n": 0}

        def beside(u, dt, bm, cm, A):
            y, h = scan_ops.mamba_scan(u, dt, bm, cm, A)
            wy, wh = mamba_scan_ref(u, dt, bm, cm, A)
            for name, got, want in (("y", y, wy), ("h", h, wh)):
                err, ok = allclose_err(got, want, STATE_TOL)
                check(ok, f"scan kernel != plain on layer {layer['n']}'s "
                      f"inputs at prompt length {len(pr)}: {name} {err}")
                layer[name] = max(layer[name], err)
            layer["n"] += 1
            return y, h

        prefill(cfg, tok, types.SimpleNamespace(mamba_scan=beside))
        check(layer["n"] == cfg.n_layers, f"{layer['n']} scans in a prefill")
        row = {"S": len(pr), "prefill_ms": ms,
               "layer_y_max_abs_err": layer["y"],
               "layer_h_max_abs_err": layer["h"]}
        for name, c in (("f32", cfg32), ("bf16", cfg)):
            lk_, hk_ = (lk, hk) if name == "bf16" else prefill(c, tok)
            lp, hp = prefill(c, tok, plain_ops)
            err, scale = diff(lk_, lp)
            h_err, h_scale = diff(hk_, hp)
            same = int(lk_.argmax()) == int(lp.argmax())
            top2 = lp.topk(2).values
            row[name] = {"max_abs_err": err, "scale": scale,
                         "h_max_abs_err": h_err, "h_scale": h_scale,
                         "greedy_equal": same,
                         "top2_margin": (top2[0] - top2[1]).item()}
            if name == "f32":
                check(err <= LOGIT_TOL * scale and h_err <= LOGIT_TOL
                      * h_scale, f"float32 prefill kernel vs plain at prompt "
                      f"length {len(pr)}: logits {err} (largest {scale}), h "
                      f"{h_err} (largest {h_scale}), tolerance {LOGIT_TOL} "
                      f"of the largest")
        out.append(row)
    worst = {k: max(o[k]["max_abs_err"] / o[k]["scale"] for o in out)
             for k in ("f32", "bf16")}
    print(f"[mamba] prefill, kernel vs plain at {cfg.n_layers} layers: on "
          f"each layer's own inputs (bf16 path) y within "
          f"{max(o['layer_y_max_abs_err'] for o in out):.3g}, h_last within "
          f"{max(o['layer_h_max_abs_err'] for o in out):.3g} (tolerance "
          f"{STATE_TOL}); float32 logits within {worst['f32']:.3g} of the "
          f"largest (tolerance {LOGIT_TOL}); bf16 logits (not held) within "
          f"{worst['bf16']:.3g} of the largest, greedy equal "
          f"{sum(o['bf16']['greedy_equal'] for o in out)}/{len(out)}")
    return out


def mamba_profile(torch, cfg, params, path):
    """Where the time goes: one decode step of the 8 sessions (on a copy of
    the first engine's state): host clock and device time with its largest
    events; each prefill's device time with the kernel's share; and the
    serving loop, ``ServeEngine.step`` over MAMBA_STEPS steps, each ending
    in its host read: wall time against device time (busy share)."""
    from repro_torch.models import model as TM
    from repro_torch.tree import tree_map
    eng = path["engines"][0]
    cache = tree_map(torch.clone, eng.cache)

    def step():
        TM.decode_step(cfg, params, cache, eng.last_tok, eng.pos)

    step()
    torch.cuda.synchronize()
    clocks = [smi_clocks()]
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    d_ms, d_events, d_top = device_ms(torch, step, iters=3)
    clocks.append(smi_clocks())
    prefill = {}
    for pr in path["prompts"]:
        tok = torch.from_numpy(pr[None]).to(eng.device)
        fn = lambda: TM.prefill(cfg, params, {"tokens": tok})     # noqa
        p_ms, p_events, p_top = device_ms(torch, fn, iters=1)
        s_ms, s_launches, _ = device_ms(torch, fn, iters=1,
                                        only="mamba_scan")
        prefill[len(pr)] = {"device_ms": p_ms, "scan_ms": s_ms,
                            "scan_share": s_ms / p_ms,
                            "scan_launches_recorded": s_launches,
                            "device_events": p_events, "top": p_top[:4]}
    server = path["engines"][-1]

    def loop():
        for _ in range(MAMBA_STEPS):
            server.step()

    loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    loop_wall = (time.perf_counter() - t0) * 1e3
    loop_dev, loop_events, _ = device_ms(torch, loop, iters=1)
    out = {"decode_wall_ms": float(np.median(walls)),
           "decode_wall_samples": walls, "decode_device_ms": d_ms,
           "decode_device_events": d_events, "decode_top": d_top,
           "decode_clocks_sm_max_power": clocks,
           "prefill_device": prefill, "loop_steps": MAMBA_STEPS,
           "loop_wall_ms": loop_wall, "loop_device_ms": loop_dev,
           "loop_device_events": loop_events,
           "loop_busy_share": loop_dev / loop_wall}
    last = prefill[len(path["prompts"][-1])]
    print(f"[mamba] decode step of {eng.M} sessions: "
          f"{out['decode_wall_ms']:.2f} ms wall, {d_ms:.2f} ms device from "
          f"{d_events:.0f} events; {MAMBA_STEPS} ServeEngine steps "
          f"{loop_wall:.1f} ms wall, {loop_dev:.1f} ms device (busy "
          f"{100 * out['loop_busy_share']:.1f} %); prefill at "
          f"{len(path['prompts'][-1])} tokens {last['device_ms']:.2f} ms "
          f"device, the scan kernel {last['scan_ms']:.2f} ms; decode "
          f"clocks.sm, max, power {' -> '.join(clocks)}")
    return out


def mamba_cpu_check(torch, dev, cfg, seed):
    """The Mamba path at CPU_MAMBA_LAYERS layers of the full width in
    float32, on the card and on the CPU (plain versions): tokens equal;
    each prefill's logits and the state after prefill and after decoding
    within 1e-3 (float32 everywhere, TF32 off, sums in another order; the
    kernel alone is held to 1e-4)."""
    import copy
    import dataclasses
    from repro_torch.models import model as TM
    cfg2 = dataclasses.replace(cfg, n_layers=CPU_MAMBA_LAYERS,
                               compute_dtype="float32")
    cpu = torch.device("cpu")
    params_g = TM.init_params(cfg2, seed=seed, device=dev)
    params_c = copy.deepcopy(params_g).to(cpu)
    g, c = (mamba_path(torch, d, cfg2, p, MAMBA_PROMPT_LENS, MAMBA_STEPS, 1,
                       seed)
            for d, p in ((dev, params_g), (cpu, params_c)))
    check(np.array_equal(g["tokens"], c["tokens"]),
          "CPU Mamba tokens != card tokens")
    logit_err = max((a.cpu() - b).abs().max().item()
                    for a, b in zip(g["logits"], c["logits"]))
    check(logit_err <= 1e-3, f"CPU Mamba prefill logits differ by "
          f"{logit_err}")
    errs = {}
    for when in ("after_prefill", "after_decode"):
        check(g[when].keys() == c[when].keys(), "CPU state keys != card")
        errs[when] = max((g[when][k].cpu() - c[when][k]).abs().max().item()
                         for k in g[when])
        check(errs[when] <= 1e-3, f"CPU Mamba state {when} differs from the "
              f"card's by {errs[when]}")
    print(f"[cpu] Mamba path at {CPU_MAMBA_LAYERS} layers of the full width, "
          f"float32: CPU tokens == card over {MAMBA_STEPS} steps; logit error"
          f" {logit_err:.3g}, state error after prefill "
          f"{errs['after_prefill']:.3g}, after decoding "
          f"{errs['after_decode']:.3g}")
    return {"layers": CPU_MAMBA_LAYERS, "decode_steps": MAMBA_STEPS,
            "prefill_logit_max_abs_err": logit_err,
            "state_max_abs_err": errs}


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
    resources = kernel_resources(_build.build_log())
    for r in resources:
        print(f"[build] {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_bytes']} spill bytes, {r['static_smem']} bytes "
              f"static shared memory")
    # the redesigned kernels must not spill (the float32 flash kernel,
    # unchanged since its first design, is reported above as it is); the
    # build log must name both, or nothing was checked
    redesigned = [r for r in resources if "flash_fwd_bf16_tc" in r["kernel"]
                  or "mamba_scan_kernel" in r["kernel"]]
    for name in ("flash_fwd_bf16_tc", "mamba_scan_kernel"):
        check(any(name in r["kernel"] for r in redesigned),
              f"the build log names no {name} instance: spills unchecked")
    check(all(r["spill_bytes"] == 0 for r in redesigned),
          f"register spills in {[r for r in redesigned if r['spill_bytes']]}")

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

    flash = flash_phase(torch, dev, rng)

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
        ms, recorded = kernel_ms(torch, call, "checksum16", iters=200)
        p_ms, p_kernels, _ = device_ms(torch, plain, iters=20)
        csum_sites.append({
            "site": site, "shape": f"({cp.shape[0]}, {cp.shape[1]}) uint8 "
            f"from byte {cs}, {valid} valid bytes, pseudo "
            f"{cps is not None}", "max_abs_err": err, "ms": ms,
            "profiler_launches_per_call": recorded,
            "plain_ms": p_ms, "plain_kernels": p_kernels,
            "call_ms": time_cuda(torch, call, iters=200),
            "plain_call_ms": time_cuda(torch, plain, iters=20),
            "bound_ms": b_ms, "bound_by": b_by})
    udp_rx_site = csum_sites[1]

    rs_call = lambda: rs_ops.encode_blocks(blocks_view, 8, 2)       # noqa
    rs_plain = lambda: rs_encode_blocks_ref(                        # noqa
        blocks_view, rs_ops.mats(8, 2)[1])
    ms_r, recorded_r = kernel_ms(torch, rs_call, "rs_encode", iters=200)
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

    # ---- 7. the LM serving path at full width ------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    cfg = get_config(LM_ARCH)
    t0 = time.time()
    params = TM.init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    lm = lm_path(torch, dev, cfg, params, PROMPT_LENS, LM_MAX_SEQ, LM_B, LM_L,
                 LM_N, SEED)
    logits = prefill_logits_check(torch, dev, cfg, params, lm["prompts"])
    prof = lm_profile(torch, cfg, params, lm)
    timing = lm_timing(torch, dev, lm)
    latency = lm_latency(torch, dev, lm)
    print(f"[lm] {LM_N} batches streamed: {timing['stream_ms_per_batch']:.2f}"
          f" ms per batch, card busy {100 * timing['busy_share']:.1f} %")
    lm_line = {"lm_path": {
        "card": card, "arch": LM_ARCH, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab, "compute": "bfloat16",
        "sessions": len(PROMPT_LENS), "max_seq": LM_MAX_SEQ,
        "prompt_lens": list(PROMPT_LENS), "B": LM_B, "L": LM_L, "N": LM_N,
        "lm_batches": lm["n_lm"], "launches": lm["launches"],
        "tokens_above_u16": lm["tokens_above_u16"],
        "params_init_s": init_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_ms": {o["S"]: o["prefill_ms"] for o in logits},
        "prefill_logits": logits, "profile": prof, "stream": timing,
        "latency": latency}}
    del lm, params

    # ---- 8. the LM path on the CPU ------------------------------------------
    cpu_lm = lm_cpu_check(torch, dev, cfg, SEED)

    # ---- 9. the Mamba path at full width and depth -------------------------
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
                  "peak_so_far_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[mamba] before the Mamba phase: {mem_before['allocated_gb']:.2f}"
          f" GB allocated; peak of the earlier phases "
          f"{mem_before['peak_so_far_gb']:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    t_mamba = time.time()
    scan = scan_phase(torch, dev, rng)
    mcfg = get_config(MAMBA_ARCH)
    t0 = time.time()
    mparams = TM.init_params(mcfg, seed=SEED)
    torch.cuda.synchronize()
    minit_s = time.time() - t0
    mp = mamba_path(torch, dev, mcfg, mparams, MAMBA_PROMPT_LENS, MAMBA_STEPS,
                    2, SEED)
    mlogits = mamba_logits_check(torch, dev, mcfg, mparams, mp["prompts"])
    mprof = mamba_profile(torch, mcfg, mparams, mp)
    mamba_line = {"mamba_path": {
        "card": card, "arch": MAMBA_ARCH, "layers": mcfg.n_layers,
        "d_model": mcfg.d_model, "d_inner": mcfg.d_inner,
        "ssm_state": mcfg.ssm_state, "vocab": mcfg.vocab,
        "compute": "bfloat16", "engines": 2,
        "sessions": len(MAMBA_PROMPT_LENS),
        "prompt_lens": list(MAMBA_PROMPT_LENS), "decode_steps": MAMBA_STEPS,
        "launches": mp["launches"], "launches_per_prefill": mcfg.n_layers,
        "two_token_prompt": mp["two_token_prompt"],
        "params_init_s": minit_s, "memory_before": mem_before,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_ms": {o["S"]: o["prefill_ms"] for o in mlogits},
        "prefill_checks": mlogits, "profile": mprof,
        "seconds": time.time() - t_mamba}}
    del mp, mparams
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. the Mamba path on the CPU --------------------------------------
    cpu_mamba = mamba_cpu_check(torch, dev, mcfg, SEED)

    # ---- 11. results --------------------------------------------------------
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
         "ms": ms_r, "profiler_launches_per_call": recorded_r,
         "plain_ms": plain_r, "bound_ms": br, "bound_by": br_by,
         "library_ms": None, "call_ms": call_r, "plain_call_ms": call_plain_r,
         "shape": f"rs_serve: ({B}, 4096) of ({B}, {L}) -> ({B}, 1024)",
         "launches_per_batch": launches["rs_encode"] // batches_run},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
         "launches": lm_line["lm_path"]["launches"]["flash_attention"],
         "max_abs_err": max(z["max_abs_err"] for z in flash["sizes"]),
         **{k: flash["sizes"][-1][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "call_ms")},
         "library": "torch.nn.functional.scaled_dot_product_attention",
         "shape": flash["sizes"][-1]["shape"],
         "sizes": flash["sizes"], "cases_checked": flash["cases"],
         "max_abs_err_all_cases": {
             dn: max(e for c, e in flash["errs"].items() if c[1] == dn)
             for dn in ("float32", "bfloat16")},
         "launches_per_prefill": cfg.n_layers,
         "resources": [r for r in resources if "flash_fwd" in r["kernel"]],
         "launch": flash["sizes"][-1]["launch"]},
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan/kernel.py:52",
         "launches": mamba_line["mamba_path"]["launches"],
         "max_abs_err": scan["max_abs_err"],
         **{k: scan["sizes"][-1][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "call_ms")},
         "library_ms": None,
         "library": "none: no single PyTorch call computes a selective scan",
         "shape": scan["sizes"][-1]["shape"], "sizes": scan["sizes"],
         "cases": scan["cases"],
         "launches_per_prefill": mcfg.n_layers,
         "resources": [r for r in resources if "mamba_scan" in r["kernel"]],
         "launch": scan["sizes"][-1]["launch"]},
    ]
    for kd in kernels[:2]:
        kd["lm_path_launches"] = lm_line["lm_path"]["launches"][kd["name"]]
    print(json.dumps(main_line))
    print(json.dumps(lm_line))
    print(json.dumps({"lm_cpu_check": cpu_lm}))
    print(json.dumps(mamba_line))
    print(json.dumps({"mamba_cpu_check": cpu_mamba}))
    print(json.dumps({"app_group_launches": app_launches,
                      "seconds": time.time() - t_all}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
