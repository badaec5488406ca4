// Reed-Solomon RS(k, p) parity over GF(256), for Hopper (sm_90a).
//
// Replaces the TPU kernel `rs_encode_pallas` / `_rs_kernel`
// (src/repro/kernels/rs_encode/kernel.py:23,38).  That kernel takes the
// shards as (k, N) and `ops.encode_blocks` transposes every request batch
// into that layout and back (src/repro/kernels/rs_encode/ops.py:36,41).
// This one reads the request layout directly: row r holds k shards of S
// bytes, row r of the output holds p parity shards of S bytes.  A (k, N)
// contiguous array is the same layout with one row and S = N.
//
// Arithmetic: multiplying by a constant c over GF(2^8) is linear over GF(2),
// so  parity_j = XOR_i XOR_b bit_b(data_i) * bp[j][i][b]  with
// bp[j][i][b] = gm[j][i] * 2^b (the bit-plane matrix of gf.py).  On a
// 32-bit word of four data bytes, shifting bit b of every byte to the
// byte's top and spreading it over the byte (one PRMT in sign-replicate
// mode) gives a byte mask m; then acc_j ^= m & rep(bp[j][i][b]), one LOP3,
// where rep() repeats the byte four times.  The host stores the repeated
// words in a kernel parameter; the shard count K and the parity count P
// are template parameters and every loop is unrolled, so each bit-plane
// word is a constant-bank operand of its LOP3, not a load.  Per word of
// four column bytes and shard: 8 x (2 + P) instructions (shift, PRMT, P
// LOP3 a bit plane).
//
// What bounds it.  RS(8, 2) over 512 requests of 4 KiB reads 2 MiB and
// writes 0.5 MiB: 0.78 us at 3.35 TB/s.  2 MiB is about what the card must
// have in flight to run at its memory rate (3.35 TB/s x ~0.5 us of latency
// = 1.7 MB), so each thread's K shard loads are written before any
// arithmetic, to have the whole batch's loads in flight at once; the
// ~1.6e7 thread-instructions of arithmetic (~0.5 us at full issue over the
// 528 schedulers) then need enough warps to issue from.
//
// Design.  One thread per V bytes of a shard column of one request, K
// loads of V bytes written before the arithmetic, the P parity vectors in
// registers.  (ptxas still places some loads later: in the (8, 2) 8-byte
// instance it issues 5 of the 8 before the arithmetic and the last 3
// between shards, by cuobjdump -sass; the 4-byte instance issues all 8
// first and is slower, so the late loads are not what bounds it.)  V is 8
// when the shard size, both row strides and both base addresses are
// multiples of 8, as on the serving path (S = 512, row stride 4160), else
// 4: the wrapper accepts any 4-byte aligned view.  On the path that is
// 32,768 threads of 8 column bytes: 256 blocks of 128 threads, 8 warps an
// SM, 64 bytes in flight a thread.  Instances: (K, P) = (8, 2), the
// serving path's pair, with K fixed; every other pair (the (k, p) sweep:
// (4, 2), (10, 4), (6, 3)) runs the K = 0 instance of its P, whose loops
// are unrolled to 16 shards under a guard on the run-time k, so its
// bit-plane operands stay constants too.
//
// Bytes a thread, timed in turns in one process on the path's batch on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6 names the runs): 8
// bytes 2.23-2.26 us, 4 bytes (16 warps an SM, 32 bytes in flight a
// thread) 2.41-2.44 us, 16 bytes (4 warps, 128 bytes) 2.54-2.62 us,
// against one PyTorch launch's 1.14-1.15 us.  8 ships: 4 bytes pays for twice
// the stores and the blocks, 16 bytes leaves one warp a scheduler to issue
// the arithmetic.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxP = 4;
constexpr int kThreads = 128;
constexpr int kVec = 8;   // bytes of a shard column a thread, when aligned

// bp[j][i][b] repeated in the four bytes of a word
struct BitPlanes {
  uint32_t v[kMaxP][kMaxK][8];
};

template <int V>
__device__ __forceinline__ void load(const uint8_t* p, uint32_t (&w)[V / 4]) {
  if constexpr (V == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x, w[1] = t.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
}

template <int V>
__device__ __forceinline__ void store(uint8_t* p, const uint32_t (&w)[V / 4]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// 0xFF in each byte of x whose bit b is set, 0x00 elsewhere: bit b moved
// to the top of its byte, then PRMT replicates each byte's sign
__device__ __forceinline__ uint32_t bit_mask(uint32_t x, int b) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(m)
      : "r"(x << (7 - b)), "r"(0u), "r"(0xBA98u));
  return m;
}

// K > 0: K shards; K == 0: k shards at run time, 1 <= k <= kMaxK.
template <int K, int P, int V>
__global__ void __launch_bounds__(kThreads)
    rs_encode_kernel(const __grid_constant__ BitPlanes bp,
                     const uint8_t* __restrict__ data, unsigned threads,
                     unsigned groups, int shard, int64_t in_stride, int k,
                     uint8_t* __restrict__ out, int64_t out_stride) {
  constexpr int NK = K > 0 ? K : kMaxK;
  constexpr int W = V / 4;
  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid >= threads) return;
  const unsigned row = gid / groups;
  const unsigned col = (gid - row * groups) * V;
  const uint8_t* in = data + row * in_stride + col;

  // every shard load first, then the arithmetic
  uint32_t x[NK][W];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    if (K > 0 || i < k) load<V>(in + static_cast<int64_t>(i) * shard, x[i]);
  }
  uint32_t acc[P][W];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[j][w] = 0u;
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    if (K > 0 || i < k) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t m = bit_mask(x[i][w], b);
#pragma unroll
          for (int j = 0; j < P; ++j) acc[j][w] ^= m & bp.v[j][i][b];
        }
      }
    }
  }
  uint8_t* o = out + row * out_stride + col;
#pragma unroll
  for (int j = 0; j < P; ++j) store<V>(o + static_cast<int64_t>(j) * shard,
                                       acc[j]);
}

template <int K, int P, int V>
void launch(const BitPlanes& bp, const uint8_t* data, int64_t rows,
            int64_t shard, int64_t in_stride, int k, uint8_t* out,
            int64_t out_stride, cudaStream_t stream) {
  const unsigned groups = static_cast<unsigned>(shard / V);
  const unsigned threads = static_cast<unsigned>(rows) * groups;
  rs_encode_kernel<K, P, V>
      <<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          bp, data, threads, groups, static_cast<int>(shard), in_stride, k,
          out, out_stride);
}

template <int V>
int dispatch(const BitPlanes& bp, const uint8_t* d, int64_t rows,
             int64_t shard, int64_t in_stride, int k, int p, uint8_t* o,
             int64_t out_stride, cudaStream_t s) {
  if (k == 8 && p == 2) {
    launch<8, 2, V>(bp, d, rows, shard, in_stride, k, o, out_stride, s);
    return 0;
  }
  switch (p) {
    case 2: launch<0, 2, V>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    case 3: launch<0, 3, V>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    case 4: launch<0, 4, V>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// data: rows x (k * shard) uint8 with row stride in_stride (bytes); out:
// rows x (p * shard) uint8 with row stride out_stride; bitplanes: host
// memory, p x k x 8 bytes.  shard, both strides and both pointers must be
// multiples of 4 (the wrapper checks).  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for k outside 1..16, p
// outside 2..4, or more than 2^31 threads.
extern "C" int beehive_rs_encode(const void* data, long long rows,
                                 long long shard, long long in_stride, int k,
                                 int p, const void* bitplanes, void* out,
                                 long long out_stride, void* stream) {
  if (k < 1 || k > kMaxK || p < 2 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || shard <= 0) return 0;
  if (rows * (shard / 4) > INT_MAX || k * shard > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  BitPlanes bp;
  memset(&bp, 0, sizeof(bp));
  const uint8_t* src = static_cast<const uint8_t*>(bitplanes);
  for (int j = 0; j < p; ++j)
    for (int i = 0; i < k; ++i)
      for (int b = 0; b < 8; ++b)
        bp.v[j][i][b] = 0x01010101u * src[(j * k + i) * 8 + b];
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide =
      ((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(o) |
        static_cast<uintptr_t>(shard) | static_cast<uintptr_t>(in_stride) |
        static_cast<uintptr_t>(out_stride)) % kVec) == 0;
  const int err =
      wide ? dispatch<kVec>(bp, d, rows, shard, in_stride, k, p, o, out_stride, s)
           : dispatch<4>(bp, d, rows, shard, in_stride, k, p, o, out_stride, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
