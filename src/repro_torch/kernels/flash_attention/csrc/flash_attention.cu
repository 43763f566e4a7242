// Blockwise (flash) attention, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   attn_kernel <- repro/kernels/flash_attention/flash_attention.py
//                  _attn_kernel (launched by flash_attention_bhsd)
//
// What it computes: for q (B, S, Hq, D) and k, v (B, T, Hkv, D), query head
// h attends over kv head h / (Hq / Hkv) (GQA by index, no kv replication):
//   out[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h/g]) v[b, t, h/g]
// with scale = 1 / sqrt(D), positions t > s + q_off masked when causal
// (q_off: the key position of q's first row, nonzero where q is a later
// block of the sequence than k and v begin with), the f32
// online-softmax carry (m, l, acc) of the TPU kernel, and the output in the
// inputs' type.  Masked scores take the -1e30 sentinel, not -inf, and the
// safe-max guards of the TPU kernel, so a row fully masked within a tile
// contributes nothing.
//
// Design.  The TPU kernel walks a (kv head, group, q block, kv block) grid
// in order and carries (m, l, acc) across kv blocks in VMEM scratch.  Here
// blocks run in parallel and in no order, so one CTA owns one (batch x q
// head, 64-row q block) and loops over the kv blocks itself, skipping every
// block that lies wholly above the diagonal.  Its 256 threads form a 16 x 16
// grid: thread (r, c) holds score rows 4r..4r+3 x columns 4c..4c+3 of each
// 64 x 64 tile, the (m, l) of its four rows in registers (the 16 threads of
// a row group agree on them through half-warp shuffles), and output rows
// 4r..4r+3 x columns {4c + 64j .. 4c + 64j + 3} of acc in registers.  The q
// tile, the K tile (transposed, so that a thread reads its four columns as
// one float4), the V tile and the probabilities live in shared memory as
// f32; bf16 inputs are widened on the way in.  Rows past S and kv columns
// past T are masked, so S and T need not be multiples of 64.
//
// What bounds it on an H100: at the LM's shape (B 2, S = T 4096, 32 q / 8 kv
// heads of 128, causal) the work is 275 GFLOP and the bytes 168 MB, so the
// bound is the bf16 tensor-core rate (0.28 ms).  This first kernel runs on
// the CUDA cores in f32, two float4 shared-memory reads per 16 to 32 FMAs:
// it is right, not fast.  wgmma on bf16 tiles, TMA and pipelining are later
// work.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int D>
struct Tiles {
  static constexpr int kQStride = D + 4;     // q rows, 16-byte aligned
  static constexpr int kPStride = kBK + 4;   // probability rows
  static constexpr int kNJ = (D + 63) / 64;  // float4 output columns/thread
  static constexpr int kFloats =
      kBQ * kQStride + D * kBK + kBK * D + kBQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
            int Hq, int Hkv, int causal, int q_off, float scale) {
  using Tl = Tiles<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBQ][D + 4]
  float* kt = qs + kBQ * Tl::kQStride;          // [D][kBK], K transposed
  float* vs = kt + D * kBK;                     // [kBK][D]
  float* ps = vs + kBK * D;                     // [kBQ][kBK + 4]

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 4;
  const int c = tid & 15;

  const long long q_pos = (long long)Hq * D;   // elements between positions
  const long long kv_pos = (long long)Hkv * D;
  const T* qp = q + (long long)b * S * q_pos + (long long)h * D;
  const T* kp = k + (long long)b * Tk * kv_pos + (long long)hk * D;
  const T* vp = v + (long long)b * Tk * kv_pos + (long long)hk * D;
  T* op = o + (long long)b * S * q_pos + (long long)h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int row = i / D, d = i % D, s = q0 + row;
    qs[row * Tl::kQStride + d] = s < S ? widen(qp[s * q_pos + d]) : 0.f;
  }

  float m[4], l[4], acc[4][Tl::kNJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Tl::kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  int n_kv = (Tk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (q_last + q_off) / kBK + 1);  // skip above

  for (int kb = 0; kb < n_kv; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i % kBK, d = i / kBK, tt = k0 + t;
      kt[d * kBK + t] = tt < Tk ? widen(kp[tt * kv_pos + d]) : 0.f;
    }
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int t = i / D, d = i % D, tt = k0 + t;
      vs[t * D + d] = tt < Tk ? widen(vp[tt * kv_pos + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows 4r.. x columns 4c..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &qs[(4 * r + i) * Tl::kQStride + d]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kv[e] = *reinterpret_cast<const float4*>(&kt[(d + e) * kBK + 4 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][j] += lane(qv[i], e) * lane(kv[e], j);
    }

    // online softmax, mirroring the TPU kernel's safe-max guards
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * r + i + q_off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * c + j;
        const bool live = kpos < Tk && (!causal || qpos >= kpos);
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe_m = m_new > kNegInf / 2 ? m_new : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] > kNegInf / 2 ? expf(s[i][j] - safe_m) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = m[i] > kNegInf / 2 ? expf(m[i] - safe_m) : 0.f;
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < Tl::kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
      *reinterpret_cast<float4*>(&ps[(4 * r + i) * Tl::kPStride + 4 * c]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc += p . v over this tile
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &ps[(4 * r + i) * Tl::kPStride + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int j = 0; j < Tl::kNJ; ++j) {
          const int col = 4 * c + 64 * j;
          if (col < D) {
            const float4 vv =
                *reinterpret_cast<const float4*>(&vs[(kk + e) * D + col]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(pv[i], e);
              acc[i][j][0] += p * vv.x;
              acc[i][j][1] += p * vv.y;
              acc[i][j][2] += p * vv.z;
              acc[i][j][3] += p * vv.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + 4 * r + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < Tl::kNJ; ++j) {
      const int col = 4 * c + 64 * j;
      if (col < D)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          narrow(acc[i][j][e] / denom, &op[s * q_pos + col + e]);
    }
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, int B, int S, int Tk,
             int Hq, int Hkv, int causal, int q_off, float scale,
             cudaStream_t stream) {
  const size_t bytes = Tiles<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  attn_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, S, Tk, Hq, Hkv, causal, q_off, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int S, int Tk,
           int Hq, int Hkv, int D, int causal, int q_off, float scale,
           cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                             q_off, scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                             q_off, scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                             q_off, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                              q_off, scale, stream);
    case 256:
      return launch_d<T, 256>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                              q_off, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define ATTN_ARGS(T)                                                        \
  const T *q, const T *k, const T *v, T *o, int B, int S, int Tk, int Hq,   \
      int Hkv, int D, int causal, int q_off, float scale,               \
      cudaStream_t stream
#define ATTN_CALL \
  launch(q, k, v, o, B, S, Tk, Hq, Hkv, D, causal, q_off, scale, stream)

extern "C" int flash_attention_f32(ATTN_ARGS(float)) { return ATTN_CALL; }
extern "C" int flash_attention_bf16(ATTN_ARGS(__nv_bfloat16)) {
  return ATTN_CALL;
}
