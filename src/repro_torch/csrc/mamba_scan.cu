// Mamba-1 selective scan, forward (prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel `mamba_scan_pallas` / `_mamba_kernel`
// (src/repro/kernels/mamba_scan/kernel.py:24,52).  It computes what that
// kernel and the oracle `mamba_scan_ref` compute, per batch row b and
// channel d, with the state h (N values) starting at zero:
//
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_n h_t[n] * C_t[n]
//
// in float32, and also writes the final state h_S (B, D, N), which prefill
// keeps as the session's cache.  The D-skip and the gate stay in the caller.
//
// What differs from the TPU kernel: its grid walks sequence blocks in
// order and carries h in VMEM scratch from one block to the next, and needs
// D and S to be multiples of its blocks.  Here the loop over the whole
// sequence runs inside each thread, so nothing is carried between blocks;
// any S >= 1, any D, and N up to 32 are taken (the ragged edges are
// masked).  B and C are read by strides, so the column slices of the
// model's x_proj output arrive with no copy; u and dt take any strides.
// No atomics: the result does not change from run to run.
//
// What bounds it: per (t, d, n) it does about 8 float32 operations (an exp
// among them) on 12 bytes per (t, d) of u, dt and y, so at the model's
// shapes (N = 16) the bytes bound it: 0.059 ms for S = 2000, D = 8192 at
// 3.35 TB/s.  This first version does not come near that: each thread runs
// a chain of S dependent steps, and one step's shuffle reduction and exp
// take longer than its share of the memory traffic.  A chunked scan across
// threads is for a later change.
//
// Design: one thread per (b, d, n); the NP >= N threads of a channel (N
// rounded up to a power of two) sit in neighbouring lanes of one warp, and
// y_t is their sum by __shfl_xor_sync.  A block of 256 threads holds
// 256 / NP channels.  It stages a chunk of timesteps of B and C (shared by
// every channel) and of u and dt (one 4-byte column per channel) in shared
// memory with coalesced loads, runs the chunk, and writes the chunk's y
// from shared memory with coalesced stores.  expf, not __expf: the fast
// exponential's error would show at the 1e-4 tolerance.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 32;                 // the state of a channel in one warp

struct Strides {
  long long b, s, c;    // batch, sequence, channel (d for u and dt, n for B, C)
};

template <int NP>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ A, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D, int N,
                      Strides us, Strides ds, Strides bs, Strides cs,
                      long long asd, long long asn) {
  constexpr int kCh = kThreads / NP;                   // channels per block
  constexpr int kChunk = kCh <= 16 ? 64 : 1024 / kCh;  // timesteps per pass
  __shared__ float sB[kChunk][NP];
  __shared__ float sC[kChunk][NP];
  __shared__ float sU[kChunk][kCh];
  __shared__ float sDt[kChunk][kCh];
  __shared__ float sY[kChunk][kCh];

  const int tid = threadIdx.x;
  const int c = tid / NP, n = tid % NP;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool live = d < D && n < N;
  // padded lanes and channels keep a = 0 and read B = u = dt = 0: their h
  // stays 0 and adds nothing to the sum
  const float a = live ? A[d * asd + n * asn] : 0.f;
  const float* ub = u + b * us.b;
  const float* db = dt + b * ds.b;
  const float* bb = bm + b * bs.b;
  const float* cb = cm + b * cs.b;
  float* yb = y + b * S * static_cast<long long>(D);
  float h = 0.f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int T = min(kChunk, S - t0);
    __syncthreads();                // the previous chunk's y is written out
    for (int i = tid; i < kChunk * NP; i += kThreads) {
      const int tt = i / NP, nn = i % NP;
      const bool ok = tt < T && nn < N;
      const long long t = t0 + tt;
      sB[tt][nn] = ok ? bb[t * bs.s + nn * bs.c] : 0.f;
      sC[tt][nn] = ok ? cb[t * cs.s + nn * cs.c] : 0.f;
    }
    for (int i = tid; i < kChunk * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      const bool ok = tt < T && d0 + cc < D;
      const long long t = t0 + tt, dd = d0 + cc;
      sU[tt][cc] = ok ? ub[t * us.s + dd * us.c] : 0.f;
      sDt[tt][cc] = ok ? db[t * ds.s + dd * ds.c] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < T; ++tt) {
      const float dtv = sDt[tt][c];
      const float decay = expf(dtv * a);
      h = decay * h + (dtv * sU[tt][c]) * sB[tt][n];
      float p = h * sC[tt][n];
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) sY[tt][c] = p;
    }
    __syncthreads();
    for (int i = tid; i < T * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (d0 + cc < D)
        yb[(t0 + tt) * static_cast<long long>(D) + d0 + cc] = sY[tt][cc];
    }
  }
  if (live) h_last[(b * D + d) * N + n] = h;
}

template <int NP>
void launch(const float* u, const float* dt, const float* bm, const float* cm,
            const float* A, float* y, float* h_last, int B, int S, int D,
            int N, Strides us, Strides ds, Strides bs, Strides cs,
            long long asd, long long asn, cudaStream_t st) {
  constexpr int kCh = kThreads / NP;
  const dim3 grid((D + kCh - 1) / kCh, B);
  mamba_scan_kernel<NP><<<grid, kThreads, 0, st>>>(
      u, dt, bm, cm, A, y, h_last, S, D, N, us, ds, bs, cs, asd, asn);
}

}  // namespace

// u, dt: (B, S, D); bm, cm: (B, S, N); A: (D, N), all float32, read by the
// strides given (in elements).  y: (B, S, D) and h_last: (B, D, N),
// contiguous float32, written.  Returns a cudaError_t.
extern "C" int beehive_mamba_scan(
    const void* u, const void* dt, const void* bm, const void* cm,
    const void* A, void* y, void* h_last, long long B, long long S,
    long long D, long long N, long long usb, long long uss, long long usd,
    long long dsb, long long dss, long long dsd, long long bsb, long long bss,
    long long bsn, long long csb, long long css, long long csn,
    long long asd, long long asn, void* stream) {
  if (N < 1 || N > kMaxN || B > 65535 || S > INT_MAX || D > INT_MAX ||
      B < 0 || S < 0 || D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || D == 0) return 0;
  const Strides us{usb, uss, usd}, ds{dsb, dss, dsd}, bs{bsb, bss, bsn},
      cs{csb, css, csn};
  const float *fu = static_cast<const float*>(u),
              *fdt = static_cast<const float*>(dt),
              *fb = static_cast<const float*>(bm),
              *fc = static_cast<const float*>(cm),
              *fa = static_cast<const float*>(A);
  float *fy = static_cast<float*>(y), *fh = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), s = static_cast<int>(S),
            d = static_cast<int>(D), n = static_cast<int>(N);
  if (n <= 1)
    launch<1>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
              asn, st);
  else if (n <= 2)
    launch<2>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
              asn, st);
  else if (n <= 4)
    launch<4>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
              asn, st);
  else if (n <= 8)
    launch<8>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
              asn, st);
  else if (n <= 16)
    launch<16>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
               asn, st);
  else
    launch<32>(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n, us, ds, bs, cs, asd,
               asn, st);
  return static_cast<int>(cudaGetLastError());
}
