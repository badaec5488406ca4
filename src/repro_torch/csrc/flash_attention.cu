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
// ridge point, so the arithmetic bounds it.  This first version does that
// arithmetic on the CUDA cores in float32, not on the tensor cores
// (mma.sync / wgmma with TMA-fed tiles are for a later change), so it
// cannot come near the bf16 tensor-core bound.
//
// Design: one block per 64-query tile of one (batch, head), 256 threads.
// Four threads share a query row; each holds a quarter of the row's q and
// of its output accumulator in registers, as float4 chunks interleaved so
// that the four threads read neighbouring 16-byte words of shared memory.
// The block walks the key tiles its queries can see (tiles wholly above the
// diagonal or wholly outside the window are skipped), staging each K and V
// tile in shared memory as float32; a score is four partial dot products
// summed with two warp shuffles.  The online softmax rescales once per key
// tile.  hd is a runtime value up to the instantiated width (32, 64, 128 or
// 256); dimensions past hd are zero in q, k and v and are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// q: (B, S, H, hd) with strides (qsb, qss) and the head axis split as
// (KV, G) with strides (qsh, qsg); k, v: (B, S, KV, hd) with strides
// (sb, ss, sh); o like q.  The last axis of every tensor is contiguous.
// dtype: 0 = float32, 1 = bfloat16 (all four tensors).  window = 0: no
// window.  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take (hd not a multiple of
// 16 in 16..256, H not a multiple of KV, a size out of int range).
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
  if (dtype == 0)
    dispatch<float>(q, k, v, o, (int)B, (int)S, (int)H, G, (int)hd, qs, ks,
                    vs, os, causal, (int)window, scale, st);
  else
    dispatch<__nv_bfloat16>(q, k, v, o, (int)B, (int)S, (int)H, G, (int)hd,
                            qs, ks, vs, os, causal, (int)window, scale, st);
  return static_cast<int>(cudaGetLastError());
}
