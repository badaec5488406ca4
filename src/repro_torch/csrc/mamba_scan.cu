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
// D and S to be multiples of its blocks.  Here a block walks the whole
// sequence of its channels in chunks and carries h from chunk to chunk in
// its own shared memory, so nothing is carried between blocks; any S >= 1, any D, and N up to 32 are taken
// (the ragged edges are masked).  B and C are read by strides, so the
// column slices of the model's x_proj output arrive with no copy; u and dt
// take any strides.  No atomics: the result does not change from run to run.
//
// What bounds it: per (t, d, n) it does about 8 float32 operations (an
// exponential among them) on 12 bytes per (t, d) of u, dt and y, so at the
// model's shapes (N = 16) the bytes bound it: 0.059 ms for S = 2000, D =
// 8192 at 3.35 TB/s.  Close behind: the 262 M exponentials at S = 2000
// take about 0.07 ms on the special-function units alone (16 a clock on
// each of 132 SMs).  What holds this design back is the queue that the
// shuffles, the shared-memory loads and the exponentials share: per 8
// (t, n) a lane issues 6 shuffles, 6 shared loads and 9 exponentials
// through it, with only 16 warps an SM (D = 8192 channels x 8 lanes) to
// hide the latency of the scan's chain of shuffles.
//
// Design: a chunked scan across threads, in the structure of the
// selective-scan kernels published with Mamba.  A block of 8 warps holds 32
// channels of one batch row; a warp holds 4 channels, 8 lanes each.  The
// sequence runs in chunks of 64 timesteps, and in a chunk each lane owns 8
// consecutive timesteps of its channel.  The chunk's u, dt, B and C are
// staged in shared memory by cp.async, the next chunk's copy in flight
// while this one computes, in three stages tracked by mbarriers rather
// than a block barrier: a stage is refilled once every warp is done with
// it, so a warp may run a chunk ahead of the slowest.  B and C (by their
// strides, 4 bytes a copy) go into [n][t] rows laid out so that each
// lane reads its 4 timesteps as one float4, a line that the warp's 4
// channels share; u and dt in 16-byte groups of 4 channels into [t][d]
// rows whose groups are XOR-swizzled by the row's lane, so that the
// lanes' reads fall in 32 different banks (four 4-byte copies a group when
// u or dt is not contiguous and 16-byte aligned).  For each state n in
// turn a lane forms its 8 decays exp2(dt * A2), with A2 = A log2(e)
// folded once (ex2.approx: one exponential per (t, d, n)), and inputs
// dt * u * B_n, and composes them into one pair (decay product, state
// from zero).  The channel's first lane applies the state the previous
// chunk left (in shared memory) to its pair; a 3-level shuffle scan over
// the channel's 8 lanes under (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2),
// each level guarded by the shuffle's own in-range predicate and the last
// one shuffling the state alone, then leaves on every lane the state
// after its steps, which one more shuffle hands to the lane above; the
// last lane's is the next chunk's carry.  The lane replays its 8 steps
// from there and adds h C_n to each of its y_t in registers, with no
// shuffle.  The states are software-pipelined: the decays of state n + 1
// are formed beside the shuffles of state n.  y is stored straight from
// registers.  Decays that underflow to 0 over a long chunk are right and
// make no NaN: no value is ever infinite.  Every warp runs every chunk (a
// channel past D computes zeros and stores nothing), so that the compiler
// knows the shuffles converged.  The first design of this kernel (one
// thread per (b, d, n) running the whole chain of S steps, y summed by
// shuffles) took 0.467 ms at S = 2000 on an H100 (PERF.md).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegs = 8;                 // lanes that split a channel's chunk
constexpr int kLevels = 3;               // of the scan over them: log2(kSegs)
static_assert(1 << kLevels == kSegs, "kSegs is a power of two");
constexpr int kCpw = 32 / kSegs;         // channels per warp: 4
constexpr int kCh = kCpw * kThreads / 32;   // channels per block: 32
constexpr int kItems = 8;                // consecutive timesteps a lane
constexpr int kChunk = kSegs * kItems;   // timesteps per pass: 64
constexpr int kLdB = kChunk + 4;         // B, C rows: float4 reads
constexpr int kMaxN = 32;
constexpr int kStages = 3;   // chunks staged: one read, one landing, and
                             // one that the slowest warp may still read
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, c;    // batch, sequence, channel (d for u and dt, n for B, C)
};

// Where timestep tt of a chunk sits in its shared row: the first four
// timesteps of every lane side by side, then the last four, so that the
// lanes' float4 reads of B and C cover whole 128-byte lines.
__device__ __forceinline__ int slot(int tt) {
  return (tt % kItems) / 4 * (kSegs * 4) + tt / kItems * 4 + tt % 4;
}

// 4 bytes from global to shared memory, or a zero when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
// 16 bytes from global to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}
// arrives on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// waits until the phase of bar with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One level of the scan over a channel's kSegs lanes, on this lane's
// pair (al, hl): when the lane off below it is in the channel,
// (ap, hp) o (al, hl) = (ap al, al hp + hl); else the pair stays.  The
// shuffle's own in-range predicate guards the update, so lanes below off
// cost no select.
__device__ __forceinline__ void scan_level(float& al, float& hl, int off) {
  asm("{\n"
      ".reg .pred p;\n"
      ".reg .f32 ap, hp;\n"
      "shfl.sync.up.b32 hp|p, %1, %2, %3, 0xffffffff;\n"
      "shfl.sync.up.b32 ap, %0, %2, %3, 0xffffffff;\n"
      "@p fma.rn.f32 %1, %0, hp, %1;\n"
      "@p mul.rn.f32 %0, %0, ap;\n"
      "}\n"
      : "+f"(al), "+f"(hl)
      : "r"(off), "r"((32 - kSegs) << 8));
}
// The last level: only the state, as no decay product is read after it.
__device__ __forceinline__ void scan_level_last(float al, float& hl,
                                                int off) {
  asm("{\n"
      ".reg .pred p;\n"
      ".reg .f32 hp;\n"
      "shfl.sync.up.b32 hp|p, %0, %2, %3, 0xffffffff;\n"
      "@p fma.rn.f32 %0, %1, hp, %0;\n"
      "}\n"
      : "+f"(hl)
      : "f"(al), "r"(off), "r"((32 - kSegs) << 8));
}
// The state entering this lane: the state after the steps of the lane
// below, or c on the channel's first lane.
__device__ __forceinline__ float scan_enter(float hl, float c) {
  float h;
  asm("{\n"
      ".reg .pred p;\n"
      ".reg .f32 he;\n"
      "shfl.sync.up.b32 he|p, %1, 1, %3, 0xffffffff;\n"
      "selp.f32 %0, he, %2, p;\n"
      "}\n"
      : "=f"(h)
      : "f"(hl), "f"(c), "r"((32 - kSegs) << 8));
  return h;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Where (timestep tt, channel cc) of a chunk sits in the u and dt tiles,
// [slot(tt)][kCh]: the 16-byte group of 4 channels is XOR-swizzled by the
// row's lane (bits 2..4 of slot), so that a warp's reads of its 4
// channels at 8 lanes' timesteps fall in 32 different banks, and a
// 16-byte copy still lands whole.
__device__ __forceinline__ int uslot(int tt, int cc) {
  static_assert(kCh == 32, "8 groups of 4 channels a row");
  const int r = slot(tt);
  return r * kCh + 4 * ((cc >> 2) ^ ((r >> 2) & 7)) + (cc & 3);
}

template <int NP>
__host__ __device__ constexpr int stage_floats() {
  return 2 * NP * kLdB + 2 * kChunk * kCh;   // B, C [NP][.]; u, dt [.][kCh]
}

template <int NP>
__host__ __device__ constexpr int smem_floats() {
  // the stages, A * log2(e) and the carried states [kCh][NP + 1], then
  // the stages' mbarriers (full, empty): 2 kStages 8-byte words
  return kStages * stage_floats<NP>() + 2 * kCh * (NP + 1) + 4 * kStages;
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 2)
    mamba_scan_kernel(const float* __restrict__ u,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ A, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D, int N,
                      Strides us, Strides ds, Strides bs, Strides cs,
                      long long asd, long long asn, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* sA2 = smem + kStages * stage_floats<NP>();   // [kCh][NP + 1]
  float* sCarry = sA2 + kCh * (NP + 1);               // [kCh][NP + 1]
  // full[s]: every thread's copies into stage s have landed; empty[s]:
  // every warp is done reading it
  uint64_t* full = reinterpret_cast<uint64_t*>(sCarry + kCh * (NP + 1));
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int seg = lane % kSegs;            // which lane of its channel
  const int cw = w * kCpw + lane / kSegs;  // its channel within the block
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  float* yb = y + b * S * static_cast<long long>(D);

  // padded states (n >= N) and channels (d >= D) get A = 0 and read
  // B = dt = u = 0: they stay 0
  for (int i = tid; i < kCh * NP; i += kThreads) {
    const int cc = i / NP, nn = i % NP;
    const bool ok = d0 + cc < D && nn < N;
    sA2[cc * (NP + 1) + nn] =
        ok ? A[(d0 + cc) * asd + nn * asn] * kLog2e : 0.f;
    sCarry[cc * (NP + 1) + nn] = 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, kThreads);
      mbar_init(empty + s, kWarps);
    }
  }
  __syncthreads();

  // This thread's share of a chunk's copies: B and C elements (tb + k
  // kStepB, nb); u and dt in groups of 4 channels (tv + k kStepV, group
  // qv), one 16-byte copy each when `vec` (the channels contiguous and
  // 16-byte aligned), else four 4-byte ones.  Timesteps past S read
  // dt = u = 0: decay 1 and input 0 leave h as it is.
  constexpr int kStepB = kThreads / NP;
  constexpr int kStepV = kThreads / (kCh / 4);
  const int nb = tid % NP, tb = tid / NP;
  const int qv = tid % (kCh / 4), tv = tid / (kCh / 4);
  const bool nb_ok = nb < N, qv_ok = d0 + 4 * qv < D;
  // a copy step of B and C moves whole runs of lanes, so slot(tt + k
  // kStepB) is slot(tt) + k (kStepB / kItems) 4
  static_assert(kStepB % kItems == 0, "a copy step moves whole runs");
  const int ob = nb * kLdB + slot(tb);
  const long long bstep = kStepB * bs.s, cstep = kStepB * cs.s;
  const float* bsrc = bm + b * bs.b + nb * bs.c + tb * bs.s;
  const float* csrc = cm + b * cs.b + nb * cs.c + tb * cs.s;
  const float* ub = u + b * us.b;
  const float* db = dt + b * ds.b;
  auto stage = [&](int t0, int s) {
    float* sB = smem + s * stage_floats<NP>();
    float* sC = sB + NP * kLdB;
    float* sU = sC + NP * kLdB;
    float* sDt = sU + kChunk * kCh;
    const float* pb = bsrc + t0 * bs.s;
    const float* pc = csrc + t0 * cs.s;
    const bool full = t0 + kChunk <= S;
#pragma unroll
    for (int k = 0; k < kChunk / kStepB; ++k) {
      const bool ok = nb_ok && (full || t0 + tb + k * kStepB < S);
      const int o = ob + k * (kStepB / kItems) * 4;
      cp_async4(sB + o, ok ? pb + k * bstep : bm, ok);
      cp_async4(sC + o, ok ? pc + k * cstep : cm, ok);
    }
    if (vec) {
#pragma unroll
      for (int k = 0; k < kChunk / kStepV; ++k) {
        const int tt = tv + k * kStepV;
        const long long t = t0 + tt;
        const bool ok = qv_ok && (full || t < S);
        const int o = uslot(tt, 4 * qv);
        cp_async16(sU + o, ok ? ub + t * us.s + d0 + 4 * qv : u, ok);
        cp_async16(sDt + o, ok ? db + t * ds.s + d0 + 4 * qv : dt, ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk / kStepV; ++k) {
        const int tt = tv + k * kStepV;
        const long long t = t0 + tt;
        const int o = uslot(tt, 4 * qv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long dd = d0 + 4 * qv + e;
          const bool ok = dd < D && t < S;
          cp_async4(sU + o + e, ok ? ub + t * us.s + dd * us.c : u, ok);
          cp_async4(sDt + o + e, ok ? db + t * ds.s + dd * ds.c : dt, ok);
        }
      }
    }
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  stage(0, 0);
  cp_async_arrive(full);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * kChunk, st = ci % kStages;
    if (ci + 1 < n_chunks) {
      // the next chunk's stage was last read at chunk ci + 1 - kStages:
      // wait for every warp to be done with it, not for every warp to
      // reach this chunk
      const int sn = (ci + 1) % kStages;
      if (ci + 1 >= kStages)
        mbar_wait(empty + sn, ((ci + 1) / kStages - 1) & 1);
      stage(t0 + kChunk, sn);
      cp_async_arrive(full + sn);
    }
    mbar_wait(full + st, (ci / kStages) & 1);   // chunk ci has landed
    // every warp runs the chunk, so that the shuffles below are known to
    // be converged; a channel past D computes zeros and stores nothing
    const float* sB = smem + st * stage_floats<NP>() + seg * 4;
    const float* sC = sB + NP * kLdB;
    // uslot(seg kItems + j, cw) is this base + uslot(j, 0) - the swizzle
    // of row j: the lane's rows all have lane bits seg
    const float* sU = smem + st * stage_floats<NP>() + 2 * NP * kLdB +
                      seg * 4 * kCh + 4 * (w ^ seg) + lane / kSegs;
    const float* sDt = sU + kChunk * kCh;
    const float* a2s = sA2 + cw * (NP + 1);
    float* carry = sCarry + cw * (NP + 1);

    // this lane's timesteps: offset j / 4 * (kSegs * 4) + j % 4 of a row
    float dtv[kItems], dtu[kItems], yv[kItems], dsum = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int o = (j / 4 * (kSegs * 4) + j % 4) * kCh;
      dtv[j] = sDt[o];
      dtu[j] = dtv[j] * sU[o];
      dsum += dtv[j];
      yv[j] = 0.f;
    }

    // Pass 1 of state n: the lane's decays and inputs, and its pair
    // (decay product, state from h = 0).
    auto pass1 = [&](int n, float (&av)[kItems], float (&bx)[kItems],
                     float& al, float& hl) {
      const float a2 = a2s[n];
      al = ex2(dsum * a2);
#pragma unroll
      for (int j = 0; j < kItems; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            sB + n * kLdB + j / 4 * (kSegs * 4));
        bx[j] = dtu[j] * b4.x;
        bx[j + 1] = dtu[j + 1] * b4.y;
        bx[j + 2] = dtu[j + 2] * b4.z;
        bx[j + 3] = dtu[j + 3] * b4.w;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        av[j] = ex2(dtv[j] * a2);
        hl = j == 0 ? bx[0] : fmaf(av[j], hl, bx[j]);   // from h = 0
      }
    };
    // Pass 2 of state n: the carry enters at the channel's first lane,
    // (a0, b0) -> (a0, a0 c + b0); the scan over the channel's lanes under
    // (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2) then leaves on every lane
    // the state after its steps, and the lane replays its steps from the
    // state after the lane below.
    auto pass2 = [&](int n, const float (&av)[kItems],
                     const float (&bx)[kItems], float al, float hl) {
      const float cin = carry[n];
      if (seg == 0) hl = fmaf(al, cin, hl);
#pragma unroll
      for (int off = 1; off < kSegs / 2; off <<= 1) scan_level(al, hl, off);
      scan_level_last(al, hl, kSegs / 2);
      float h = scan_enter(hl, cin);   // the state before my steps
      // the channel's last lane leaves the state after the chunk
      if (seg == kSegs - 1) carry[n] = hl;
#pragma unroll
      for (int j = 0; j < kItems; j += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(
            sC + n * kLdB + j / 4 * (kSegs * 4));
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h = fmaf(av[j + e], h, bx[j + e]);
          yv[j + e] = fmaf(h, cv[e], yv[j + e]);
        }
      }
    };
    // software-pipelined over the states: pass 1 of the next state runs
    // beside the shuffles of this one
    float av0[kItems], bx0[kItems], av1[kItems], bx1[kItems];
    float al0, hl0, al1, hl1;
    pass1(0, av0, bx0, al0, hl0);
#pragma unroll
    for (int n = 0; n < NP; n += 2) {
      pass1(n + 1, av1, bx1, al1, hl1);
      pass2(n, av0, bx0, al0, hl0);
      if (n + 2 < NP) pass1(n + 2, av0, bx0, al0, hl0);
      pass2(n + 1, av1, bx1, al1, hl1);
    }

    // y straight from registers: the warp's 4 channels are 16
    // contiguous bytes of each of its 8 rows per store
    if (d0 + cw < D) {
      float* py = yb + (t0 + seg * kItems) * static_cast<long long>(D) +
                  d0 + cw;
      const int n_rows = min(kItems, S - t0 - seg * kItems);
      if (n_rows == kItems) {
#pragma unroll
        for (int j = 0; j < kItems; ++j, py += D) *py = yv[j];
      } else {
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          if (j < n_rows) py[j * static_cast<long long>(D)] = yv[j];
      }
    }
    // this warp is done with the stage, and its carries are written
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  __syncthreads();   // the last chunk's carries are written
  for (int i = tid; i < kCh * NP; i += kThreads) {
    const int cc = i / NP, nn = i % NP;
    if (d0 + cc < D && nn < N)
      h_last[(b * D + d0 + cc) * N + nn] = sCarry[cc * (NP + 1) + nn];
  }
}

template <int NP>
cudaError_t launch(const float* u, const float* dt, const float* bm,
                   const float* cm, const float* A, float* y, float* h_last,
                   int B, int S, int D, int N, Strides us, Strides ds,
                   Strides bs, Strides cs, long long asd, long long asn,
                   int vec, cudaStream_t st) {
  constexpr int smem = smem_floats<NP>() * sizeof(float);
  auto kernel = mamba_scan_kernel<NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((D + kCh - 1) / kCh, B);
  kernel<<<grid, kThreads, smem, st>>>(u, dt, bm, cm, A, y, h_last, S, D, N,
                                       us, ds, bs, cs, asd, asn, vec);
  return cudaGetLastError();
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
  // u and dt in 16-byte groups of channels when those are contiguous and
  // 16-byte aligned (the model's tensors); element by element otherwise
  auto aligned = [](const void* p, long long sb, long long ss, long long B) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ss % 4 == 0 &&
           (B == 1 || sb % 4 == 0);
  };
  const int vec = usd == 1 && dsd == 1 && D % 4 == 0 &&
                  aligned(u, usb, uss, B) && aligned(dt, dsb, dss, B);
  auto run = [&](auto launcher) {
    return static_cast<int>(launcher(fu, fdt, fb, fc, fa, fy, fh, b, s, d, n,
                                     us, ds, bs, cs, asd, asn, vec, st));
  };
  // the state width rounded up: 16 (falcon-mamba) or 32
  if (n <= 16) return run(launch<16>);
  return run(launch<32>);
}
