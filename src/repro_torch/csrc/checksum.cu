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
// What bounds it: device-memory bytes.  Each row's valid prefix is read
// once (about 2.1 MB for a 512 x 4160 batch of full frames, ~0.6 us at
// 3.35 TB/s) and the arithmetic is one add per byte; the IP-header calls
// read at most 60 bytes a row and are bound by the launch.  Design: one
// warp per row, reading only the valid prefix, 16 bytes per thread per step
// where the row start is 16-byte aligned (bytes otherwise), a warp-shuffle
// reduction in uint32 (addition mod 2^32 is associative, so the result is
// bit-identical in any order), and lane 0 folds and writes.  The TPU kernel
// instead loads whole (8, L) blocks and masks them; reading only the prefix
// moves fewer bytes for short packets.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;

// Sum of the two 16-bit words in a little-endian 32-bit load taken at an
// even offset from `start`: bytes 0 and 2 are high bytes, 1 and 3 low bytes.
__device__ __forceinline__ uint32_t word_pair_sum(uint32_t w) {
  const uint32_t hi = w & 0x00FF00FFu;
  const uint32_t lo = (w >> 8) & 0x00FF00FFu;
  return (((hi & 0xFFFFu) + (hi >> 16)) << 8) + (lo & 0xFFFFu) + (lo >> 16);
}

__global__ void checksum16_kernel(const uint8_t* __restrict__ payload,
                                  int64_t rows, int64_t width,
                                  int64_t row_stride, int64_t start,
                                  const int32_t* __restrict__ length,
                                  const int64_t* __restrict__ pseudo,
                                  int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp shares the row
  const int64_t span = width > start ? width - start : 0;
  int64_t n = length[row];
  n = n < 0 ? 0 : (n > span ? span : n);
  const uint8_t* p = payload + row * row_stride + start;

  uint32_t acc = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const int64_t chunks = aligned ? n / 16 : 0;
  for (int64_t c = lane; c < chunks; c += 32) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + c);
    acc += word_pair_sum(v.x) + word_pair_sum(v.y) + word_pair_sum(v.z) +
           word_pair_sum(v.w);
  }
  for (int64_t q = chunks * 16 + lane; q < n; q += 32) {
    const uint32_t b = p[q];
    acc += (q & 1) ? b : (b << 8);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) {
    uint32_t t = acc + (pseudo ? static_cast<uint32_t>(pseudo[row]) : 0u);
    for (int i = 0; i < 3; ++i) t = (t & 0xFFFFu) + (t >> 16);
    out[row] = static_cast<int64_t>((~t) & 0xFFFFu);
  }
}

}  // namespace

// payload: rows x width uint8 with the given row stride (bytes); length:
// rows int32; pseudo: rows int64 or null; out: rows int64.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int beehive_checksum16(const void* payload, long long rows,
                                  long long width, long long row_stride,
                                  long long start, const void* length,
                                  const void* pseudo, void* out,
                                  void* stream) {
  if (rows <= 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  checksum16_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), rows, width, row_stride, start,
      static_cast<const int32_t*>(length),
      static_cast<const int64_t*>(pseudo), static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
