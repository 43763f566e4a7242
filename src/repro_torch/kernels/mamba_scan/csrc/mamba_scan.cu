// Selective scan (the Mamba-1 recurrence), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   scan_kernel <- repro/kernels/mamba_scan/mamba_scan.py _scan_kernel
//                  (launched by mamba_scan_pallas)
//
// What it computes, for x, dt (B, L, d), Bt, Ct (B, L, N), A (d, N) and
// D (d,), all f32, with h = 0 at t = 0:
//   h[b, c, :] <- exp(dt[b, t, c] * A[c, :]) * h[b, c, :]
//                 + (dt[b, t, c] * x[b, t, c]) * Bt[b, t, :]
//   y[b, t, c]  = sum_n h[b, c, n] * Ct[b, t, n] + D[c] * x[b, t, c]
// and returns y (B, L, d) and the final h (B, d, N).  The operations keep
// the TPU kernel's order (exp of dt * A, then the update, then the sum over
// states, then the D term), with expf, so that the plain version's 1e-4
// bound holds over long sequences.
//
// Design.  The recurrence is sequential in time and independent across
// (batch, channel).  The TPU kernel walks a (d_block, N) state tile per time
// chunk on a (batch, channel block, time chunk) grid, carrying the state in
// VMEM scratch.  Here four lanes share one channel, each holding four of its
// N <= 16 states in registers (states past N stay zero), and a CTA of 32
// channels walks the whole sequence itself: per 64-step chunk it stages x
// and dt of its channels, and Bt and Ct (which every channel of a batch row
// reads) in shared memory, steps through the chunk, reduces y over the four
// lanes with two shuffles, and writes the chunk of y back coalesced.  Four
// lanes per channel give B x d x 4 threads: 65,536 at the LM's width
// (B 2, d 8192), where one thread per channel would leave the card's
// schedulers with one warp each.
//
// What bounds it on an H100: at (B 2, L 4096, d 8192, N 16) it moves
// 0.81 GB (x, dt read, y written: 0.24 ms at 3.35 TB/s) and takes 1.07e9
// exponentials on the special-function units (16 per SM per clock: 0.26 ms
// at 1.98 GHz), so the exponentials bound it, barely.  This first kernel
// pays one expf per state per step with no reuse, and one warp-synchronous
// reduction per step.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kStates = 4;                    // states per lane
constexpr int kMaxN = kLanes * kStates;       // 16
constexpr int kChannels = 32;                 // channels per CTA
constexpr int kThreads = kChannels * kLanes;  // 128
constexpr int kChunk = 64;                    // time steps staged at once

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ Bt, const float* __restrict__ Ct,
            const float* __restrict__ A, const float* __restrict__ Dv,
            float* __restrict__ y, float* __restrict__ h_out, int L, int d,
            int N) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float ys[kChunk][kChannels];
  __shared__ float4 bs[kChunk][kLanes];  // Bt[t, 4 * lane ..], 0 past N
  __shared__ float4 cs[kChunk][kLanes];

  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lc = tid / kLanes;
  const int ln = tid % kLanes;
  const int ch = ch0 + lc;
  const bool live = ch < d;

  float a[kStates], h[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = ln * kStates + j;
    a[j] = live && n < N ? A[(long long)ch * N + n] : 0.f;
    h[j] = 0.f;
  }
  const float dv = live ? Dv[ch] : 0.f;

  const long long row = (long long)b * L;
  const float* xb = x + row * d;
  const float* dtb = dt + row * d;
  const float* bb = Bt + row * N;
  const float* cb = Ct + row * N;
  float* yb = y + row * d;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int len = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's ys are written out
    for (int i = tid; i < kChunk * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      const bool ok = t < len && ch0 + cc < d;
      const long long g = (long long)(t0 + t) * d + ch0 + cc;
      xs[t][cc] = ok ? xb[g] : 0.f;
      dts[t][cc] = ok ? dtb[g] : 0.f;
    }
    for (int i = tid; i < kChunk * kMaxN; i += kThreads) {
      const int t = i / kMaxN, n = i % kMaxN;
      const bool ok = t < len && n < N;
      const long long g = (long long)(t0 + t) * N + n;
      reinterpret_cast<float*>(bs)[i] = ok ? bb[g] : 0.f;
      reinterpret_cast<float*>(cs)[i] = ok ? cb[g] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float xt = xs[t][lc];
      const float dtt = dts[t][lc];
      const float4 bv = bs[t][ln];
      const float4 cv = cs[t][ln];
      const float dx = dtt * xt;
      h[0] = expf(dtt * a[0]) * h[0] + dx * bv.x;
      h[1] = expf(dtt * a[1]) * h[1] + dx * bv.y;
      h[2] = expf(dtt * a[2]) * h[2] + dx * bv.z;
      h[3] = expf(dtt * a[3]) * h[3] + dx * bv.w;
      float part = h[0] * cv.x + h[1] * cv.y + h[2] * cv.z + h[3] * cv.w;
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (ln == 0) ys[t][lc] = part + dv * xt;
    }
    __syncthreads();
    for (int i = tid; i < len * kChannels; i += kThreads) {
      const int t = i / kChannels, cc = i % kChannels;
      if (ch0 + cc < d) yb[(long long)(t0 + t) * d + ch0 + cc] = ys[t][cc];
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      const int n = ln * kStates + j;
      if (n < N) h_out[((long long)b * d + ch) * N + n] = h[j];
    }
  }
}

}  // namespace

extern "C" int mamba_scan_f32(const float* x, const float* dt,
                              const float* Bt, const float* Ct,
                              const float* A, const float* Dv, float* y,
                              float* h, int B, int L, int d, int N,
                              cudaStream_t stream) {
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  dim3 grid((d + kChannels - 1) / kChannels, B);
  scan_kernel<<<grid, kThreads, 0, stream>>>(x, dt, Bt, Ct, A, Dv, y, h, L,
                                             d, N);
  return (int)cudaGetLastError();
}
