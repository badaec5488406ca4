// RFC 1071 internet checksum over a batch of byte rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel `checksum_pallas` / `_csum_kernel`
// (src/repro/kernels/checksum/kernel.py:18,32) and the lax twins the JAX
// stack really calls, `bytesops.checksum16` and `checksum16_with_pseudo`
// (src/repro/net/bytesops.py:107,133): per row, the big-endian 16-bit words
// of [start, start + clamp(length, 0, width - start)) are summed mod 2^32,
// an optional pseudo-header partial sum is added, the carries are folded
// three times and the result is complemented.  An odd tail byte is the high
// byte of a word padded with zero, so odd widths and odd lengths work.
//
// What bounds it.  On the RS path (512 rows of stride 4160, start 0) the
// udp_rx call reads ~4,116 valid bytes a row, 2.1 MB in all: 0.62 us at
// 3.35 TB/s; udp_tx ~1,041 bytes a row; ip_rx and ip_tx 20 bytes a row.
// 2.1 MB is about what the card must have in flight to run at its memory
// rate (3.35 TB/s x ~0.5 us of latency = 1.7 MB), so the goal is not a
// streaming pipeline but every load of the batch issued at once, across
// the SMs, then one reduction.  Below that, a kernel costs about a
// microsecond however little it does, and each memory round trip that
// waits on another adds to it: the IP calls are a launch, one round trip
// and a reduction.
//
// Design.  A warp a row, four rows a block (512 rows: 128 blocks, one an
// SM).  A row splits into head bytes up to the first 16-byte aligned
// address, 16-byte chunks, and tail bytes after the last whole chunk inside
// the row; lanes 0-15 take the head bytes and 16-31 the tail bytes, so rows
// that are not 16-byte aligned (odd `start`, odd widths, strided views)
// keep the vector loads for all but at most 30 bytes.  A pass is up to 9
// rounds of one 16-byte load a lane (4,608 bytes: a 4 KiB request with its
// headers is one pass), every load issued before any add, with 32-bit
// chunk offsets from a 64-bit row base.  The first round goes out before
// `length` arrives (speculative: bounded by the row, so always in bounds;
// 512 bytes a row, all that an IP header needs); the other rounds the
// prefix reaches go out once it has, from chunks of the prefix only (a
// lane past its last chunk loads that chunk again).  Only those rounds are
// added (one path for one round, one for two, one for nine).  Each chunk's
// even and odd bytes are summed by IDP4A into a pair of sums of its own
// round (no chain of adds through one register).  In a one-round pass
// whole chunks are kept by selects; in a longer one every slot past the
// prefix holds its last chunk, so all slots are added and that chunk's
// sums taken back out, one multiply a pass instead of a select a round.
// The chunk the prefix's end cuts is masked by bytes once a row.  The warp
// reduces by REDUX, lane 0 adds the pseudo term, folds and writes: no
// atomics, no output to zero first.  Addition mod 2^32 is associative and
// the take-back exact mod 2^32, so the result is bit-identical.
//
// Bytes read on the RS path, a batch of four calls: the valid prefixes
// rounded up to 16 bytes (2.7 MB) plus the first round's 512 bytes of each
// row at the two IP calls (0.5 MB): 3.2 MB.
//
// Designs timed against this one on an NVIDIA H100 80GB HBM3 at 700 W, in
// turns in one process at the RS path's four call sites (PERF.md section
// 6 names the runs), ip_rx / udp_rx / udp_tx / ip_tx, us:
//   this design 1.42 / 1.88-1.90 / 1.71-1.72 / 1.42-1.43; one PyTorch
//     launch 1.14-1.15;
//   every load after `length` 1.51 / 1.87-1.88 / 1.68 / 1.52: it reads
//     the 2.7 MB, and the IP calls wait two round trips;
//   lane 0 waits for `length`, then copies the pass's chunks into shared
//     memory with one cp.async.bulk (TMA) completing on an mbarrier, and
//     the warp sums from shared memory: 1.65 / 1.99 / 1.76 / 1.65.  The
//     copy adds a wait on the barrier and buys nothing at these sizes;
//   a block of 128 threads a row (a pass split over four warps, their
//     sums joined through shared memory after a barrier): 1.67 / 1.88 /
//     1.78 / 1.66, 6.98 a batch against this design's 6.46 in the same
//     run; 256 threads 7.42, 64 threads 7.32, a warp in a block of its
//     own 7.81.  A block a row ties at udp_rx, which moving 2.1 MB from
//     L2 bounds, and loses ~0.24 us at each IP call (4x the blocks, a
//     barrier; that build also loaded every round whatever the length).
// The speculative round saves a round trip at each IP call and costs up
// to 0.03 us at the UDP calls.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;               // rows a block, a warp each
constexpr int kLoads = 9;              // rounds of 16-byte loads a pass
constexpr int kPass = 32 * kLoads;     // chunks a pass: 4,608 bytes

// Adds the bytes of a 16-byte chunk into two sums: bytes 0, 2, ... of the
// chunk into `ev`, bytes 1, 3, ... into `od` (two IDP4A a word).
__device__ __forceinline__ void add_chunk(const uint4& v, uint32_t& ev,
                                          uint32_t& od) {
  ev = __dp4a(v.x, 0x00010001u, ev);
  od = __dp4a(v.x, 0x01000100u, od);
  ev = __dp4a(v.y, 0x00010001u, ev);
  od = __dp4a(v.y, 0x01000100u, od);
  ev = __dp4a(v.z, 0x00010001u, ev);
  od = __dp4a(v.z, 0x01000100u, od);
  ev = __dp4a(v.w, 0x00010001u, ev);
  od = __dp4a(v.w, 0x01000100u, od);
}

// v masked to its first `valid` bytes, 0 <= valid < 16, without a branch
__device__ __forceinline__ uint4 prefix(const uint4& v, int valid) {
  auto word = [valid](uint32_t w, int at) {
    const int vb = min(max(valid - at, 0), 4);
    return w & __funnelshift_rc(0xFFFFFFFFu, 0u, 32 - 8 * vb);
  };
  return make_uint4(word(v.x, 0), word(v.y, 4), word(v.z, 8), word(v.w, 12));
}

// A 16-byte load through the read-only path.  Volatile, so that the
// compiler issues it where it stands, not at its first use.
__device__ __forceinline__ uint4 ldg16(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Loads of rounds [u0, R) of a pass: chunk c + 32 u, or `last` for a lane
// past it, all issued before any is used.
template <int R>
__device__ __forceinline__ void load_rounds(uint4 (&v)[kLoads], int u0,
                                            const uint4* chunks, int c,
                                            int last) {
#pragma unroll
  for (int u = 0; u < R; ++u)
    if (u >= u0) v[u] = ldg16(chunks + min(c + 32 * u, last));
}

// Adds rounds [0, R) of a pass: the chunks wholly inside the prefix (index
// < whole) into the sums; the chunk that the prefix's end cuts, when this
// lane loaded it, into `part`.  Straight-line: selects, no branches.
template <int R>
__device__ __forceinline__ void add_rounds(const uint4 (&v)[kLoads], int c,
                                           int whole, int lim,
                                           uint32_t (&ev)[kLoads],
                                           uint32_t (&od)[kLoads],
                                           uint4& part) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    uint32_t e = 0, o = 0;
    add_chunk(v[u], e, o);
    const int cu = c + 32 * u;
    ev[u] += cu < whole ? e : 0u;
    od[u] += cu < whole ? o : 0u;
    if (cu == whole && whole < lim) part = v[u];
  }
}

// The same for a pass whose loads clamp to chunk lim - 1 (every round but
// the speculative first): every slot at or past `whole` then holds that
// chunk, so all slots are added and that chunk's sums are taken back out
// once for each such slot (one multiply, not a select a round); the lane
// whose own chunk is `whole`, when the prefix's end cuts it, keeps it in
// `part`.
template <int R>
__device__ __forceinline__ void add_rounds_clamped(
    const uint4 (&v)[kLoads], int c, int whole, int lim,
    uint32_t (&ev)[kLoads], uint32_t (&od)[kLoads], uint4& part) {
  const uint32_t e0 = ev[R - 1], o0 = od[R - 1];
#pragma unroll
  for (int u = 0; u < R; ++u) add_chunk(v[u], ev[u], od[u]);
  const int over =
      c + 32 * (R - 1) < whole ? 0 : R - max(0, (whole - c + 31) >> 5);
  ev[0] -= over * (ev[R - 1] - e0);   // the last slot's chunk sums
  od[0] -= over * (od[R - 1] - o0);
  if (whole < lim && whole >= c && whole - c < 32 * R && !((whole - c) & 31))
    part = v[R - 1];
}

__global__ void __launch_bounds__(32 * kRows)
    checksum16_kernel(const uint8_t* __restrict__ payload, int rows,
                      int width, int64_t row_stride, int start,
                      const int32_t* __restrict__ length,
                      const int64_t* __restrict__ pseudo,
                      int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + warp;
  if (row >= rows) return;   // the whole warp shares the row
  const uint32_t ps =
      (lane == 0 && pseudo) ? static_cast<uint32_t>(pseudo[row]) : 0u;
  const int span = width > start ? width - start : 0;
  const uint8_t* p = payload + row * row_stride + start;
  const int head =
      min(span, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15))
                                 & 15));
  const int body = (span - head) >> 4;   // whole 16-byte chunks in the row
  const int tail = head + 16 * body;     // offset of the tail bytes
  const uint4* chunks = reinterpret_cast<const uint4*>(p + head);

  uint4 v[kLoads];
  // the first round, before `length` arrives
  if (body > 0) v[0] = ldg16(chunks + min(lane, body - 1));
  const int n = min(max(length[row], 0), span);
  // chunks that hold bytes of the valid prefix [0, n), and those wholly in it
  const int lim = n > head ? min(body, (n - head + 15) >> 4) : 0;
  const int whole = n > head ? min(body, (n - head) >> 4) : 0;
  // the head and tail bytes: bounded by the row, so issued at once
  const int q = lane < 16 ? lane : tail + lane - 16;
  const bool edge = lane < 16 ? q < head : q < span;
  const uint32_t eb = edge ? p[q] : 0u;

  // sums of the chunks' even / odd bytes, a pair a round; `part` holds the
  // chunk that the end of the prefix cuts, in the lane that loaded it
  uint32_t ev[kLoads] = {}, od[kLoads] = {};
  uint4 part = make_uint4(0u, 0u, 0u, 0u);
  for (int c0 = 0; c0 < lim; c0 += kPass) {
    const int c = c0 + lane;
    const int rounds = (min(lim - c0, kPass) + 31) / 32;
    // the pass's loads from chunks of the prefix (a lane past the last
    // one reads it again); the speculative first round is in flight
    const int u0 = c0 == 0 ? 1 : 0;
    if (rounds <= 1) load_rounds<1>(v, u0, chunks, c, lim - 1);
    else if (rounds <= 2) load_rounds<2>(v, u0, chunks, c, lim - 1);
    else load_rounds<kLoads>(v, u0, chunks, c, lim - 1);
    // only the rounds the prefix reaches
    if (rounds <= 1)
      add_rounds<1>(v, c, whole, lim, ev, od, part);
    else if (rounds <= 2)
      add_rounds_clamped<2>(v, c, whole, lim, ev, od, part);
    else
      add_rounds_clamped<kLoads>(v, c, whole, lim, ev, od, part);
  }
  add_chunk(prefix(part, n - head - 16 * whole), ev[0], od[0]);
  uint32_t e = 0, o = 0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) e += ev[u], o += od[u];
  // every chunk starts at an offset of head's parity
  uint32_t hi = (head & 1) ? o : e, lo = (head & 1) ? e : o;
  if (edge && q < n) {
    if (q & 1) lo += eb;
    else hi += eb;
  }
  const uint32_t acc = __reduce_add_sync(0xFFFFFFFFu, (hi << 8) + lo);
  if (lane == 0) {
    uint32_t s = acc + ps;
    for (int i = 0; i < 3; ++i) s = (s & 0xFFFFu) + (s >> 16);
    out[row] = static_cast<int64_t>((~s) & 0xFFFFu);
  }
}

}  // namespace

// payload: rows x width uint8 with the given row stride (bytes); length:
// rows int32; pseudo: rows int64 or null; out: rows int64.  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue when
// rows, width or start does not fit in 31 bits.
extern "C" int beehive_checksum16(const void* payload, long long rows,
                                  long long width, long long row_stride,
                                  long long start, const void* length,
                                  const void* pseudo, void* out,
                                  void* stream) {
  if (rows <= 0) return 0;
  if (width > INT_MAX || start < 0 || start > INT_MAX || rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kRows - 1) / kRows;
  checksum16_kernel
      <<<static_cast<unsigned>(blocks), 32 * kRows, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(payload), static_cast<int>(rows),
          static_cast<int>(width), row_stride, static_cast<int>(start),
          static_cast<const int32_t*>(length),
          static_cast<const int64_t*>(pseudo), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
