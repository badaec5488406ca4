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
// bp[j][i][b] = gm[j][i] * 2^b (the bit-plane matrix of gf.py).  On 32-bit
// words, ((x >> b) & 0x01010101) * bp puts bp into every byte whose bit b is
// set, with no carries between bytes (SWAR), so one multiply-xor serves four
// bytes.  The bit-plane matrix (at most 8 x 16 x 8 bytes) is a kernel
// parameter, read through the constant cache: every thread of a warp reads
// the same entry at the same time.
//
// What bounds it: for RS(8, 2) at 512 requests of 4 KiB, 2 MiB in and
// 0.5 MiB out (~0.8 us at 3.35 TB/s), against 8 * k * p = 128 shift-and-
// multiply-xor steps per 4 output-column bytes, about 2.5e7 integer
// instructions over 132 SMs; both are small, so at this size the launch and
// the tail of the grid dominate.  Design: one thread per 32-bit column word
// of one request, all p parity words in registers (p is a template
// parameter), k loads of 4 bytes each, coalesced across the warp.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// p is a template parameter; the instantiations are the parity counts the
// port runs: RS(8, 2) on the serving path, and p = 3, 4 in the (k, p) sweep.
constexpr int kMaxK = 16;
constexpr int kMaxP = 4;
constexpr int kThreads = 256;

struct BitPlanes {
  uint8_t v[kMaxP][kMaxK][8];
};

template <int P>
__global__ void rs_encode_kernel(const __grid_constant__ BitPlanes bp,
                                 const uint8_t* __restrict__ data,
                                 int64_t rows, int64_t shard,
                                 int64_t in_stride, int k,
                                 uint8_t* __restrict__ out,
                                 int64_t out_stride) {
  const int64_t words = shard / 4;
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= rows * words) return;
  const int64_t row = gid / words;
  const int64_t w = gid - row * words;
  const uint32_t* in =
      reinterpret_cast<const uint32_t*>(data + row * in_stride) + w;
  uint32_t acc[P];
#pragma unroll
  for (int j = 0; j < P; ++j) acc[j] = 0u;
  for (int i = 0; i < k; ++i) {
    const uint32_t x = __ldg(in + i * words);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const uint32_t bits = (x >> b) & 0x01010101u;
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j] ^= bits * bp.v[j][i][b];
    }
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(out + row * out_stride) + w;
#pragma unroll
  for (int j = 0; j < P; ++j) o[j * words] = acc[j];
}

template <int P>
void launch(const BitPlanes& bp, const uint8_t* data, int64_t rows,
            int64_t shard, int64_t in_stride, int k, uint8_t* out,
            int64_t out_stride, cudaStream_t stream) {
  const int64_t threads = rows * (shard / 4);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rs_encode_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      bp, data, rows, shard, in_stride, k, out, out_stride);
}

}  // namespace

// data: rows x (k * shard) uint8 with row stride in_stride (bytes); out:
// rows x (p * shard) uint8 with row stride out_stride; bitplanes: host
// memory, p x k x 8 bytes.  shard, both strides and both pointers must be
// multiples of 4 (the wrapper checks).  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for k outside 1..16 or p
// outside 2..4.
extern "C" int beehive_rs_encode(const void* data, long long rows,
                                 long long shard, long long in_stride, int k,
                                 int p, const void* bitplanes, void* out,
                                 long long out_stride, void* stream) {
  if (k < 1 || k > kMaxK || p < 2 || p > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || shard <= 0) return 0;
  BitPlanes bp;
  memset(&bp, 0, sizeof(bp));
  const uint8_t* src = static_cast<const uint8_t*>(bitplanes);
  for (int j = 0; j < p; ++j)
    for (int i = 0; i < k; ++i)
      for (int b = 0; b < 8; ++b) bp.v[j][i][b] = src[(j * k + i) * 8 + b];
  const uint8_t* d = static_cast<const uint8_t*>(data);
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 2: launch<2>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    case 3: launch<3>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    case 4: launch<4>(bp, d, rows, shard, in_stride, k, o, out_stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
