// Selective scan (the Mamba-1 recurrence), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   scan_kernel <- repro/kernels/mamba_scan/mamba_scan.py _scan_kernel
//                  (launched by mamba_scan_pallas)
//
// What it computes, for x, dt (B, L, d), Bt, Ct (B, L, N), A (d, N) and
// D (d,), all f32, with h = h0 at t = 0 (h0 (B, d, N), zero when the
// caller passes none: a later block of a sequence starts from the state
// the earlier blocks leave):
//   h[b, c, :] <- exp(dt[b, t, c] * A[c, :]) * h[b, c, :]
//                 + (dt[b, t, c] * x[b, t, c]) * Bt[b, t, :]
//   y[b, t, c]  = sum_n h[b, c, n] * Ct[b, t, n] + D[c] * x[b, t, c]
// and returns y (B, L, d) and the final h (B, d, N).  The operations keep
// the TPU kernel's order (the decay of dt * A, then the update, then the
// sum over states, then the D term).  The entry takes d a multiple of 4 and
// N = 16: the wrapper pads other shapes with zeros (a padded state has
// A = B = C = 0 and stays 0; a padded channel is never stored).
//
// What bounds it on an H100: at (B 2, L 4096, d 8192, N 16) it moves
// 0.81 GB (x, dt read, y written: 0.24 ms at 3.35 TB/s) and takes 1.07e9
// exponentials on the special-function units (16 per SM per clock: 0.26 ms
// at 1.98 GHz).  The instructions around them come close as well: at 4.2e12
// warp-instructions/s of issue, every instruction per state-step costs
// 0.032 ms, so the walk has to stay near 8 per state-step, and enough warps
// have to be in flight to hide the latency of each step's dependent chain.
//
// Design.  The recurrence is sequential in time and independent across
// (batch, channel).  Four lanes share one channel, each holding four of its
// 16 states in registers; a CTA of 128 threads owns 32 channels of one batch
// row and walks the whole sequence, 32 steps (a chunk) at a time.
//   - Loads: thread 0 fetches each chunk with four TMA loads (x and dt as
//     32 steps x 32 channels, Bt and Ct as 32 steps x 16 states; zeros past
//     L and d) into a two-chunk ring, each slot with an mbarrier that the
//     copies complete by bytes.  The slot of chunk k + 2 is refilled as soon
//     as chunk k is done with, so chunk k + 1 lands while chunk k is walked.
//   - Per state-step the walk issues one multiply and one ex2.approx (A is
//     scaled by log2(e) once, at load), one multiply of dt x by Bt, and two
//     FMAs (the update and the y partial).  Per lane-step it adds two 16-byte
//     loads (Bt, Ct), two 4-byte broadcast loads (x, dt, which TMA lands as
//     rows of 32 channels; a 16-byte load of four steps would need a
//     transposing pass that costs more than it saves) and one store of the
//     lane's partial y.
//   - y is reduced off the per-step path: after the walk the four partials
//     of each (step, channel) are summed from shared memory with the D term,
//     and the chunk of y is written coalesced.
//   - 40 KB of shared memory and about 40 registers per thread let every
//     CTA of the LM's grid (512 CTAs of 128 threads) be resident at once.
//
// ptxas (-Xptxas -v): see PERF.md.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                     // lanes per channel
constexpr int kStates = 4;                    // states per lane
constexpr int kN = kLanes * kStates;          // 16
constexpr int kChannels = 32;                 // channels per CTA
constexpr int kThreads = kChannels * kLanes;  // 128
constexpr int kChunk = 32;                    // time steps per TMA load
constexpr float kLog2e = 1.4426950408889634f;

struct __align__(128) Slot {
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float b[kChunk][kN];
  float c[kChunk][kN];
};
constexpr uint32_t kSlotBytes = sizeof(Slot);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until the phase of ``bar`` with this parity has completed; a wait
// of more than 2^33 clocks (about 4 s) means a lost arrival, and traps
// rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Chunk ``k`` of batch row ``b`` into ``slot`` (one thread).
__device__ __forceinline__ void fetch(Slot* slot, uint64_t* bar,
                                      const CUtensorMap* xm,
                                      const CUtensorMap* dtm,
                                      const CUtensorMap* bm,
                                      const CUtensorMap* cm, int ch0, int k,
                                      int b) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(kSlotBytes)
      : "memory");
  tma_load_3d(slot->x, xm, bar, ch0, k * kChunk, b);
  tma_load_3d(slot->dt, dtm, bar, ch0, k * kChunk, b);
  tma_load_3d(slot->b, bm, bar, 0, k * kChunk, b);
  tma_load_3d(slot->c, cm, bar, 0, k * kChunk, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const __grid_constant__ CUtensorMap xm,
            const __grid_constant__ CUtensorMap dtm,
            const __grid_constant__ CUtensorMap bm,
            const __grid_constant__ CUtensorMap cm,
            const float* __restrict__ A, const float* __restrict__ Dv,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ h_out, int L, int d) {
  __shared__ Slot ring[2];
  __shared__ __align__(16) float part[kChunk][kThreads];  // partial y
  __shared__ __align__(8) uint64_t full[2];

  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lc = tid / kLanes;
  const int ln = tid % kLanes;
  const int ch = ch0 + lc;
  const int n_chunks = (L + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < 2 && k < n_chunks; ++k)
      fetch(&ring[k], &full[k], &xm, &dtm, &bm, &cm, ch0, k, b);
  }

  float a[kStates], h[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    a[j] = ch < d ? A[(long long)ch * kN + kStates * ln + j] * kLog2e : 0.f;
    h[j] = h0 != nullptr && ch < d
               ? h0[((long long)b * d + ch) * kN + kStates * ln + j]
               : 0.f;
  }
  // the reduction pass always serves channel ch0 + tid % 32
  const int rc = tid % kChannels;
  const float dv = ch0 + rc < d ? Dv[ch0 + rc] : 0.f;
  float* yb = y + (long long)b * L * d + ch0 + rc;
  __syncthreads();  // the barriers are initialised

  for (int k = 0; k < n_chunks; ++k) {
    const int s = k & 1;
    const Slot& sl = ring[s];
    const int len = min(kChunk, L - k * kChunk);
    mbar_wait(&full[s], (k >> 1) & 1);

#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float xt = sl.x[t][lc];
      const float dtt = sl.dt[t][lc];
      const float4 bv = *reinterpret_cast<const float4*>(&sl.b[t][4 * ln]);
      const float4 cv = *reinterpret_cast<const float4*>(&sl.c[t][4 * ln]);
      const float dx = dtt * xt;
      h[0] = ex2(dtt * a[0]) * h[0] + dx * bv.x;
      h[1] = ex2(dtt * a[1]) * h[1] + dx * bv.y;
      h[2] = ex2(dtt * a[2]) * h[2] + dx * bv.z;
      h[3] = ex2(dtt * a[3]) * h[3] + dx * bv.w;
      part[t][tid] = h[0] * cv.x + h[1] * cv.y + h[2] * cv.z + h[3] * cv.w;
    }
    __syncthreads();  // every partial of the chunk is written

    for (int t = tid / kChannels; t < len; t += kThreads / kChannels) {
      const float4 p = *reinterpret_cast<const float4*>(&part[t][4 * rc]);
      if (ch0 + rc < d)
        yb[(long long)(k * kChunk + t) * d] =
            ((p.x + p.y) + (p.z + p.w)) + dv * sl.x[t][rc];
    }
    __syncthreads();  // slot s and the partials are free
    if (tid == 0 && k + 2 < n_chunks)
      fetch(&ring[s], &full[s], &xm, &dtm, &bm, &cm, ch0, k + 2, b);
  }

  if (ch < d) {
#pragma unroll
    for (int j = 0; j < kStates; ++j)
      h_out[((long long)b * d + ch) * kN + kStates * ln + j] = h[j];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A (W, L, B) f32 tensor map over t (B, L, W), boxes of ``box_w`` x kChunk,
// zeros outside; the encoder comes through cudaGetDriverEntryPoint.
bool make_map(CUtensorMap* map, const float* t, int W, int L, int B,
              int box_w) {
  static EncodeTiled enc = nullptr;
  if (enc == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    enc = reinterpret_cast<EncodeTiled>(p);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)L * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, (cuuint32_t)kChunk, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(t),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch geometry: a CTA per 32 channels of one batch row, static
// shared memory only.
struct Plan {
  dim3 grid, block;
  size_t smem;
};

Plan plan(int B, int d) {
  return {dim3((d + kChannels - 1) / kChannels, B), dim3(kThreads), 0};
}

void put(const Plan& g, int* out) {
  const int v[11] = {(int)g.grid.x, (int)g.grid.y, (int)g.grid.z,
                     (int)g.block.x, (int)g.block.y, (int)g.block.z,
                     (int)g.smem, 1, 1, 1, 0};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

}  // namespace

// The geometry the launcher below uses for (B, L, d, N), into out[11]:
// grid xyz, block xyz, dynamic shared bytes, cluster xyz, cooperative.
extern "C" int mamba_scan_plan_f32(int B, int L, int d, int N, int* out) {
  if (N != kN || d % 4 != 0 || L < 1) return (int)cudaErrorInvalidValue;
  put(plan(B, d), out);
  return 0;
}

// scan_kernel's attributes (variant 0, the only one) and its CTAs per SM
// at `smem` dynamic bytes, into out[6]: registers, local bytes, static
// shared bytes, max threads, max dynamic shared bytes, occupancy.
extern "C" int mamba_scan_attrs_f32(int variant, int smem, int* out) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, scan_kernel);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, scan_kernel,
                                                        kThreads, smem);
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    a.maxThreadsPerBlock, a.maxDynamicSharedSizeBytes, occ};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}

// x, dt (B, L, d), Bt, Ct (B, L, 16), A (d, 16), D (d,), h0 (B, d, 16) or
// null -> y (B, L, d), h (B, d, 16); d a multiple of 4, every pointer
// 16-byte aligned.
extern "C" int mamba_scan_f32(const float* x, const float* dt,
                              const float* Bt, const float* Ct,
                              const float* A, const float* Dv,
                              const float* h0, float* y, float* h, int B,
                              int L, int d, int N, cudaStream_t stream) {
  if (N != kN || d % 4 != 0 || L < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, dtm, bm, cm;
  if (!make_map(&xm, x, d, L, B, kChannels) ||
      !make_map(&dtm, dt, d, L, B, kChannels) ||
      !make_map(&bm, Bt, kN, L, B, kN) || !make_map(&cm, Ct, kN, L, B, kN))
    return (int)cudaErrorInvalidValue;
  const Plan g = plan(B, d);
  scan_kernel<<<g.grid, g.block, g.smem, stream>>>(xm, dtm, bm, cm, A, Dv, h0,
                                                   y, h, L, d);
  return (int)cudaGetLastError();
}
