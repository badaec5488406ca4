// Flash attention, forward (prefill), for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/kernel.py:25,68).  It computes what
// that kernel and the oracle `attention_ref` compute: softmax(q k^T / sqrt(hd))
// v per query head, with the query head h reading kv head h / G (GQA), a
// causal mask (key <= query) and a sliding-window mask (query - key <
// window), masked scores set to -1e30, the running max, denominator and
// accumulator in float32, and the denominator floored at 1e-30.
//
// What differs from the TPU kernel: it reads q (B, S, H, hd) and k, v
// (B, S, KV, hd) by strides -- the layout the model's attention layer
// produces, with no transposes; the head axis of q and o may be split into
// (KV, G) with strides of their own.  Any S: the ragged tail of the last
// query and key tiles is masked here, where the TPU version needed S to be
// a multiple of its block.  No atomics, so the result does not change from
// run to run.
//
// What bounds it: at the model's prefill shapes (S up to 2048, H = 16,
// hd = 64) the work is 4 * hd flops per unmasked (query, key) pair, about
// 8 GFLOP for S = 2000 against 16 MB of q, k, v and o: far above the card's
// ridge point, so the arithmetic bounds it -- 0.0083 ms at the 989 TFLOP/s
// of the bf16 tensor cores.
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the model's path): a FlashAttention-2 style kernel on the tensor
// cores.  A block of 4 warps takes a 64-query tile of one (batch, head);
// each warp owns 16 query rows.  Causal blocks take two tiles, the longest
// and the shortest left (nq - 1 - x, then x), so that every block does the
// same work: with B * H = 16 the grid is about one wave, and without the
// pairing the SMs that drew the long tiles set the time.  Q and tiles of
// 128 keys (64 for hd = 128, 32 for hd = 256) of K and V are copied into
// shared memory as bf16 with 16-byte cp.async, rows padded by 16 bytes so
// that ldmatrix is free of bank conflicts, the next K/V tile in flight
// while this one computes (two stages).  Q goes into registers once as mma
// A-fragments (for hd = 256 it is read from shared memory at each step, to
// leave registers for the 16 x 256 float32 accumulator).  S = Q K^T runs as
// mma.sync m16n8k16 bf16 -> float32 over the whole instance width (columns
// past hd are zero, and straight-line code overlaps the steps); the online
// softmax runs on the accumulator fragments, a row's max over its quad of
// threads by two shuffles, exp2 with scale * log2(e) folded in; masks are
// applied only on tiles that hold a masked (query, key) pair, and a warp
// skips a tile none of its rows can see.  P is rounded to bf16 and fed from
// registers as the A operand of the P V mma (V by ldmatrix.trans): the
// model's own attention rounds its weights to V's dtype the same way.
// Instances: hd 32, 64, 128, 256 (a multiple of 16 up to 256 runs in the
// next instance up).  The first design of this path (float32 FMAs on the
// CUDA cores, below) took 0.947 ms at S = 2000 on an H100 (PERF.md).
//
// float32 (the checks' path, within 2e-5, which rules out TF32 and bf16
// tensor cores): float32 FMAs on the CUDA cores.  One block per 64-query
// tile of one (batch, head), 256 threads.  Four threads share a query row;
// each holds a quarter of the row's q and of its output accumulator in
// registers, as float4 chunks interleaved so that the four threads read
// neighbouring 16-byte words of shared memory.  The block walks the key
// tiles its queries can see (tiles wholly above the diagonal or wholly
// outside the window are skipped), staging each K and V tile in shared
// memory as float32; a score is four partial dot products summed with two
// warp shuffles.  The online softmax rescales once per key tile.  hd is a
// runtime value up to the instantiated width (32, 64, 128 or 256);
// dimensions past hd are zero in q, k and v and are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kBQ = 64;                  // queries per block
constexpr int kLanes = 4;                // threads per query row
constexpr int kThreads = kBQ * kLanes;   // 256
constexpr float kNegInf = -1e30f;        // the reference's masked score

struct Strides {
  long long b, s, h, g;   // batch, sequence, head (or kv head), group
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int G,
                 int hd, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int window, float scale) {
  constexpr int NC = HD / (4 * kLanes);  // float4 chunks per thread
  constexpr int HC = HD / 4;             // float4 chunks per row
  __shared__ float4 sk[BK][HC];
  __shared__ float4 sv[BK][HC];

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int g = h % G;
  const int qpos = q0 + row;

  // this thread's chunks of the query row: chunk 4 * m + lane
  float qr[NC][4];
  const T* qrow = q + b * qs.b + (long long)min(qpos, S - 1) * qs.s +
                  kvh * qs.h + g * qs.g;
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (4 * m + lane) + e;
      qr[m][e] = d < hd ? to_f32(qrow[d]) : 0.f;
    }
  float acc[NC][4];
#pragma unroll
  for (int m = 0; m < NC; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  // the keys any query of this tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? q_last + 1 : S;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  const T* kbase = k + b * ks.b + kvh * ks.h;
  const T* vbase = v + b * vs.b + kvh * vs.h;
  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * HC; i += kThreads) {
      const int r = i / HC, c = i % HC, kp = kt + r;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (kp < S) {
        const T* kr = kbase + (long long)kp * ks.s;
        const T* vr = vbase + (long long)kp * vs.s;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * c + e;
          if (d < hd) {
            kx[e] = to_f32(kr[d]);
            vx[e] = to_f32(vr[d]);
          }
        }
      }
      sk[r][c] = make_float4(kx[0], kx[1], kx[2], kx[3]);
      sv[r][c] = make_float4(vx[0], vx[1], vx[2], vx[3]);
    }
    __syncthreads();

    float s[BK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float4 kx = sk[j][4 * m + lane];
        part = fmaf(qr[m][0], kx.x, part);
        part = fmaf(qr[m][1], kx.y, part);
        part = fmaf(qr[m][2], kx.z, part);
        part = fmaf(qr[m][3], kx.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = kt + j;
      bool ok = kp < S;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && (qpos - kp) < window;
      s[j] = ok ? part * scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m_run, m_tile);
    const float corr = expf(m_run - m_new);
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] *= corr;
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l_tile += p;
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float4 vx = sv[j][4 * m + lane];
        acc[m][0] = fmaf(p, vx.x, acc[m][0]);
        acc[m][1] = fmaf(p, vx.y, acc[m][1]);
        acc[m][2] = fmaf(p, vx.z, acc[m][2]);
        acc[m][3] = fmaf(p, vx.w, acc[m][3]);
      }
    }
    l_run = l_run * corr + l_tile;
    m_run = m_new;
  }

  if (qpos < S) {
    const float den = fmaxf(l_run, 1e-30f);
    T* orow = o + b * os.b + (long long)qpos * os.s + kvh * os.h + g * os.g;
#pragma unroll
    for (int m = 0; m < NC; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (4 * m + lane) + e;
        if (d < hd) store(acc[m][e] / den, &orow[d]);
      }
  }
}

template <typename T, int HD, int BK>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int H, int G, int hd, Strides qs, Strides ks, Strides vs,
            Strides os, int causal, int window, float scale,
            cudaStream_t stream) {
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD, BK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, G, hd, qs, ks, vs, os,
      causal, window, scale);
}

template <typename T>
void dispatch(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int G, int hd, Strides qs, Strides ks, Strides vs,
              Strides os, int causal, int window, float scale,
              cudaStream_t st) {
  // key-tile depth per width keeps the K and V tiles at 32 KB of shared
  // memory together (16 KB for hd <= 32) and the scores in registers
  if (hd <= 32)
    launch<T, 32, 64>(q, k, v, o, B, S, H, G, hd, qs, ks, vs, os, causal,
                      window, scale, st);
  else if (hd <= 64)
    launch<T, 64, 64>(q, k, v, o, B, S, H, G, hd, qs, ks, vs, os, causal,
                      window, scale, st);
  else if (hd <= 128)
    launch<T, 128, 32>(q, k, v, o, B, S, H, G, hd, qs, ks, vs, os, causal,
                       window, scale, st);
  else
    launch<T, 256, 16>(q, k, v, o, B, S, H, G, hd, qs, ks, vs, os, causal,
                       window, scale, st);
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;   // 128
constexpr int kTcBQ = 16 * kTcWarps;        // 64 queries per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 float32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int BK>
__host__ __device__ constexpr int tc_smem_bytes() {
  // Q (kTcBQ rows) and two stages of K and V (BK rows each), rows of HD + 8
  return (kTcBQ + 4 * BK) * (HD + 8) * static_cast<int>(sizeof(bf16));
}

// QREG: Q held in registers as A-fragments rather than re-read
template <int HD, int BK, bool QREG>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_bf16_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  int G, int hd, Strides qs, Strides ks, Strides vs,
                  Strides os, int causal, int window, float sl2) {
  constexpr int LD = HD + 8;     // padded row, in bf16 elements
  constexpr int CH = HD / 8;     // 16-byte chunks per row
  constexpr int NT = BK / 8;     // 8-key column tiles of S
  constexpr int DT = HD / 8;     // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kTcBQ * LD;          // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;         // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G, g = h % G;
  const int nchunk = hd / 8;

  const bf16* qbase = q + b * qs.b + kvh * qs.h + g * qs.g;
  const bf16* kbase = k + b * ks.b + kvh * ks.h;
  const bf16* vbase = v + b * vs.b + kvh * vs.h;

  // this thread's 16-byte column of the rows it copies: rows lr + i RSTEP
  constexpr int RSTEP = kTcThreads / CH;
  static_assert(BK % RSTEP == 0, "a tile is whole passes of the block");
  const int lr = tid / CH, lc = tid % CH;
  const bool c_ok = lc < nchunk;
  const uint32_t sk0 = smem_u32(sK + lr * LD + lc * 8);
  const uint32_t sv0 = smem_u32(sV + lr * LD + lc * 8);
  const bf16* kcol = kbase + lc * 8;
  const bf16* vcol = vbase + lc * 8;
  const long long kstep = RSTEP * ks.s, vstep = RSTEP * vs.s;

  // A causal block takes query tile nq - 1 - x and then x, so that every
  // block does the same work (the grid has (nq + 1) / 2 columns).
  const int nq = (S + kTcBQ - 1) / kTcBQ;
  const int x = blockIdx.x;
  const int first = causal ? nq - 1 - x : x;
  const int n_pass = causal && first != x ? 2 : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int q0 = (pass == 0 ? first : x) * kTcBQ;
    for (int i = tid; i < kTcBQ * CH; i += kTcThreads) {
      const int r = i / CH, c = i % CH, qp = q0 + r;
      const bool ok = qp < S && c < nchunk;
      cp_async16(smem_u32(sQ + r * LD + c * 8),
                 ok ? qbase + (long long)qp * qs.s + c * 8 : qbase, ok);
    }
    auto load_kv = [&](int kt, int stage) {
      const uint32_t dk = sk0 + stage * BK * LD * 2;   // bytes
      const uint32_t dv = sv0 + stage * BK * LD * 2;
      const bf16* pk = kcol + (long long)(kt + lr) * ks.s;
      const bf16* pv = vcol + (long long)(kt + lr) * vs.s;
      if (kt + BK <= S && c_ok) {   // the common case: no masks
#pragma unroll
        for (int i = 0; i < BK / RSTEP; ++i) {
          cp_async16(dk + i * RSTEP * LD * 2, pk + i * kstep, true);
          cp_async16(dv + i * RSTEP * LD * 2, pv + i * vstep, true);
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < BK / RSTEP; ++i) {
        const bool ok = c_ok && kt + lr + i * RSTEP < S;
        cp_async16(dk + i * RSTEP * LD * 2, ok ? pk + i * kstep : kbase, ok);
        cp_async16(dv + i * RSTEP * LD * 2, ok ? pv + i * vstep : vbase, ok);
      }
    };

    // the keys any query of this tile can see, from a tile-aligned start
    const int q_last = min(q0 + kTcBQ, S) - 1;
    const int k_hi = causal ? q_last + 1 : S;
    const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
    const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

    load_kv(k_lo, 0);
    cp_async_commit();   // Q and the first K/V tile

    const int qw0 = q0 + warp * 16;          // this warp's first row
    const int qa = qw0 + gid;                // this thread's rows qa, qa + 8
    uint32_t qf[QREG ? HD / 16 : 1][4];
    float oacc[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    // ldmatrix row addresses of this lane: A operands (Q) and K as B
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int a_col = (lane >> 4) * 8;
    const int k_row = (lane & 7) + (lane >> 4) * 8;
    const int k_col = ((lane >> 3) & 1) * 8;
    const bf16* sQw = sQ + (warp * 16 + a_row) * LD + a_col;

    for (int it = 0; it < n_tiles; ++it) {
      const int kt = k_lo + it * BK;
      if (it + 1 < n_tiles) {
        load_kv(kt + BK, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if constexpr (QREG) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            ldsm_x4(qf[kk], smem_u32(sQw + kk * 16));
        }
      }
      const bf16* tk = sK + (it & 1) * BK * LD;
      const bf16* tv = sV + (it & 1) * BK * LD;
      // a warp skips a tile none of its rows can see
      bool skip = qw0 >= S;
      if (causal && kt > qw0 + 15) skip = true;
      if (window > 0 && qw0 - (kt + BK - 1) >= window) skip = true;
      if (!skip) {
        float sacc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
        // S = Q K^T over the whole padded width: the columns past hd are
        // zero in Q and K, and straight-line code overlaps the steps
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t a[4];
          if constexpr (QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
          } else {
            ldsm_x4(a, smem_u32(sQw + kk * 16));
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t kb[4];
            ldsm_x4(kb, smem_u32(tk + (np * 16 + k_row) * LD + kk * 16 +
                                 k_col));
            mma_bf16(sacc[2 * np], a, kb[0], kb[1]);
            mma_bf16(sacc[2 * np + 1], a, kb[2], kb[3]);
          }
        }
        const bool need_mask = kt + BK > S ||
                               (causal && kt + BK - 1 > qw0) ||
                               (window > 0 && qw0 + 15 - kt >= window);
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kp = kt + j * 8 + tig * 2 + (e & 1);
              const int qp = qa + (e >> 1) * 8;
              bool ok = kp < S;
              if (causal) ok = ok && kp <= qp;
              if (window > 0) ok = ok && qp - kp < window;
              if (!ok) sacc[j][e] = kNegInf;
            }
        }
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sacc[j][0], sacc[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sacc[j][2], sacc[j][3]));
        }
        float ms[2], ls[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
          const float corr = ex2((m_run[r] - mx[r]) * sl2);
          m_run[r] = mx[r];
          l_run[r] *= corr;
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            oacc[j][2 * r] *= corr;
            oacc[j][2 * r + 1] *= corr;
          }
          // a row that has seen only masked keys so far keeps p = 0 there
          ms[r] = mx[r] == kNegInf ? 0.f : mx[r] * sl2;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sacc[j][e] = ex2(fmaf(sacc[j][e], sl2, -ms[e >> 1]));
            ls[e >> 1] += sacc[j][e];
          }
        l_run[0] += ls[0];
        l_run[1] += ls[1];
        // O += P V, P rounded to bf16 and packed as A-fragments straight
        // from the S fragments, V by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint32_t pa[4] = {
              pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
          for (int dp = 0; dp < HD / 16; ++dp) {
            uint32_t vb[4];
            ldsm_x4_t(vb, smem_u32(tv + (kk * 16 + a_row) * LD + dp * 16 +
                                   a_col));
            mma_bf16(oacc[2 * dp], pa, vb[0], vb[1]);
            mma_bf16(oacc[2 * dp + 1], pa, vb[2], vb[3]);
          }
        }
      }
      __syncthreads();   // this stage is consumed before it is refilled
    }

    bf16* obase = o + b * os.b + kvh * os.h + g * os.g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qp = qa + r * 8;
      if (qp < S) {
        bf16* orow = obase + (long long)qp * os.s;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int d = j * 8 + tig * 2;
          if (d < hd)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(oacc[j][2 * r] * inv,
                                      oacc[j][2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD, int BK, bool QREG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int G, int hd, Strides qs,
                      Strides ks, Strides vs, Strides os, int causal,
                      int window, float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD, BK>();
  auto kernel = flash_fwd_bf16_tc<HD, BK, QREG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int nq = (S + kTcBQ - 1) / kTcBQ;
  const dim3 grid(causal ? (nq + 1) / 2 : nq, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, G, hd, qs, ks,
      vs, os, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// keys per tile and Q in registers, per width: the accumulator of hd = 256
// (16 x 256 float32, 128 registers a thread) leaves room for 32-key tiles
// with Q read from shared memory
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int G, int hd, Strides qs,
                        Strides ks, Strides vs, Strides os, int causal,
                        int window, float scale, cudaStream_t st) {
  auto run = [&](auto launcher) {
    return launcher(q, k, v, o, B, S, H, G, hd, qs, ks, vs, os, causal,
                    window, scale, st);
  };
  if (hd <= 32) return run(launch_tc<32, 64, true>);
  if (hd <= 64) return run(launch_tc<64, 128, true>);
  if (hd <= 128) return run(launch_tc<128, 64, true>);
  return run(launch_tc<256, 32, false>);
}

}  // namespace

// q: (B, S, H, hd) with strides (qsb, qss) and the head axis split as
// (KV, G) with strides (qsh, qsg); k, v: (B, S, KV, hd) with strides
// (sb, ss, sh); o like q.  The last axis of every tensor is contiguous.
// dtype: 0 = float32, 1 = bfloat16 (all four tensors; then every pointer
// and stride a multiple of 16 bytes).  window = 0: no window.  Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape it does not take (hd not a multiple of 16 in 16..256, H not a
// multiple of KV, a size out of int range, a bf16 row not 16-byte aligned).
extern "C" int beehive_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long B,
    long long S, long long H, long long KV, long long hd, long long qsb,
    long long qss, long long qsh, long long qsg, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long osg, int causal, long long window,
    int dtype, void* stream) {
  if (hd < 16 || hd > 256 || hd % 16 != 0 || KV <= 0 || H % KV != 0 ||
      B > 65535 || H > 65535 || S > (1LL << 30) || window < 0 ||
      window > (1LL << 30) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const Strides qs{qsb, qss, qsh, qsg}, ks{ksb, kss, ksh, 0},
      vs{vsb, vss, vsh, 0}, os{osb, oss, osh, osg};
  const int G = static_cast<int>(H / KV);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(q, k, v, o, (int)B, (int)S, (int)H, G, (int)hd, qs, ks,
                    vs, os, causal, (int)window, scale, st);
  } else {
    for (const void* p : {q, k, v, static_cast<const void*>(o)})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long sizes[4] = {B, S, KV, G};
    const Strides* all[4] = {&qs, &ks, &vs, &os};
    for (const Strides* s : all) {
      const long long strides[4] = {s->b, s->s, s->h, s->g};
      for (int i = 0; i < 4; ++i)
        if (sizes[i] > 1 && strides[i] % 8 != 0)
          return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(dispatch_tc(q, k, v, o, (int)B, (int)S, (int)H, G,
                                        (int)hd, qs, ks, vs, os, causal,
                                        (int)window, scale, st));
  }
  return static_cast<int>(cudaGetLastError());
}
