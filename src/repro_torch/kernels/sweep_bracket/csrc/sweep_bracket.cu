// Fused bracket-term segment sums and a generic CSR segment sum for the
// scenario sweep, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   * bracket_kernel  <- repro/kernels/sweep_bracket/sweep_bracket.py
//                        _bracket_kernel (launched by bracket_segsum_padded)
//   * segsum_kernel   <- repro/kernels/sweep_bracket/sweep_bracket.py
//                        _segsum_kernel (launched by segsum_padded)
//
// bracket_kernel computes, for every scenario s and call-site c, with
// d = CXL_LAT[s] - MEM_LAT[s]:
//   hit_degraded[s, c]   = sum over hit samples of c  of w * max(lat + d, 0)
//   lfb_mem[s, c]        = sum over LFB samples of c  of w * max(lat + d, 0)
//   lfb_half[s, c]       = sum over LFB samples of c  of w * max(lat + d/2, 0)
//   miss_congested[s, c] = sum over miss samples of c of w * max(CXL_LAT[s], lat + d)
//
// Design.  The TPU kernel built a one-hot (block_n, n_seg) matrix per sample
// tile and reduced on the MXU, carrying the sums in VMEM across a sequential
// sample-block grid axis.  Both are TPU artefacts.  Here the samples are
// grouped by site in CSR form (offsets[c] .. offsets[c + 1], optionally
// through a stable permutation when the ids are not sorted), the grid is
// (scenario block, site), and each thread owns one scenario: it walks its
// site's hit, LFB and miss samples in a fixed order and keeps the four sums
// in registers.  The block stages the site's samples through shared memory,
// tile by tile, so every thread reads the same sample (a broadcast).  There
// are no atomics, so the result is deterministic and a scenario's row does
// not depend on which other scenarios share the launch (chunking the
// scenario axis is bit-identical).
//
// What bounds it on an H100: the float64 arithmetic over S x sum(n) terms
// (about four operations a term) and the writes of four (S, n_seg) arrays.
// The bundle itself (a few hundred samples) stays resident in L2 and is read
// from device memory once.  The writes are strided by n_seg between
// neighbouring threads; putting the scenario index on neighbouring output
// addresses, and lower precision, are left for later work.
//
// segsum_kernel: x (rows, n) row-major and CSR offsets over the n columns
// give out (rows, n_seg); one thread per row, columns summed in CSR order.
//
// Each extern "C" launcher enqueues on the given stream, allocates nothing,
// and returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // threads per block: one scenario (or row) each
constexpr int kTile = 256;   // samples staged in shared memory per step

template <typename T>
struct Group {
  const T* lat;
  const T* w;
  const int* offsets;  // (n_seg + 1,) CSR offsets into the (permuted) samples
  const int* perm;     // (n,) stable permutation to site order, or nullptr
};

template <typename T>
__device__ __forceinline__ T maxv(T a, T b) { return a > b ? a : b; }

// Walk the samples of site c in CSR order, staging them through shared
// memory; f(lat, w) runs once per sample in every thread of the block.
// begin/end are uniform over the block, so the barriers are too.
template <typename T, typename F>
__device__ __forceinline__ void for_site(const Group<T>& g, int c, T* s_lat,
                                         T* s_w, F f) {
  const int begin = g.offsets[c];
  const int end = g.offsets[c + 1];
  for (int base = begin; base < end; base += kTile) {
    const int n = min(kTile, end - base);
    __syncthreads();  // the previous tile has been consumed
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int i = g.perm ? g.perm[base + j] : base + j;
      s_lat[j] = g.lat[i];
      s_w[j] = g.w[i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) f(s_lat[j], s_w[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
bracket_kernel(Group<T> hit, Group<T> lfb, Group<T> miss,
               const T* __restrict__ delta, const T* __restrict__ cxl,
               int S, int n_seg, T* __restrict__ o_hit,
               T* __restrict__ o_lmem, T* __restrict__ o_lhalf,
               T* __restrict__ o_mcong) {
  __shared__ T s_lat[kTile];
  __shared__ T s_w[kTile];
  const int c = blockIdx.y;
  const long long s = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = s < S;
  const T d = live ? delta[s] : T(0);
  const T x = live ? cxl[s] : T(0);
  const T half = d / T(2);
  const T zero = T(0);

  T a_hit = zero, a_lmem = zero, a_lhalf = zero, a_mcong = zero;
  for_site(hit, c, s_lat, s_w, [&](T lat, T w) {
    a_hit += w * maxv(lat + d, zero);
  });
  for_site(lfb, c, s_lat, s_w, [&](T lat, T w) {
    a_lmem += w * maxv(lat + d, zero);
    a_lhalf += w * maxv(lat + half, zero);
  });
  for_site(miss, c, s_lat, s_w, [&](T lat, T w) {
    a_mcong += w * maxv(x, lat + d);
  });

  if (live) {
    const long long o = s * n_seg + c;
    o_hit[o] = a_hit;
    o_lmem[o] = a_lmem;
    o_lhalf[o] = a_lhalf;
    o_mcong[o] = a_mcong;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
segsum_kernel(const T* __restrict__ x, int rows, int n,
              const int* __restrict__ offsets, const int* __restrict__ perm,
              int n_seg, T* __restrict__ out) {
  const int c = blockIdx.y;
  const long long r = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (r >= rows) return;
  const T* xr = x + r * n;
  T acc = T(0);
  const int end = offsets[c + 1];
  for (int i = offsets[c]; i < end; ++i) acc += xr[perm ? perm[i] : i];
  out[r * n_seg + c] = acc;
}

template <typename T>
int launch_bracket(const T* hl, const T* hw, const int* ho, const int* hp,
                   const T* ll, const T* lw, const int* lo, const int* lp,
                   const T* ml, const T* mw, const int* mo, const int* mp,
                   const T* delta, const T* cxl, int S, int n_seg,
                   T* o_hit, T* o_lmem, T* o_lhalf, T* o_mcong,
                   void* stream) {
  const dim3 grid((S + kBlock - 1) / kBlock, n_seg);
  bracket_kernel<T><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      Group<T>{hl, hw, ho, hp}, Group<T>{ll, lw, lo, lp},
      Group<T>{ml, mw, mo, mp}, delta, cxl, S, n_seg, o_hit, o_lmem, o_lhalf,
      o_mcong);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_segsum(const T* x, int rows, int n, const int* offsets,
                  const int* perm, int n_seg, T* out, void* stream) {
  const dim3 grid((rows + kBlock - 1) / kBlock, n_seg);
  segsum_kernel<T><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      x, rows, n, offsets, perm, n_seg, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define BRACKET_ARGS(T)                                                      \
  const T *hl, const T *hw, const int *ho, const int *hp, const T *ll,       \
      const T *lw, const int *lo, const int *lp, const T *ml, const T *mw,   \
      const int *mo, const int *mp, const T *delta, const T *cxl, int S,     \
      int n_seg, T *o_hit, T *o_lmem, T *o_lhalf, T *o_mcong, void *stream
#define BRACKET_CALL                                                         \
  launch_bracket(hl, hw, ho, hp, ll, lw, lo, lp, ml, mw, mo, mp, delta, cxl, \
                 S, n_seg, o_hit, o_lmem, o_lhalf, o_mcong, stream)

extern "C" int sweep_bracket_f64(BRACKET_ARGS(double)) { return BRACKET_CALL; }
extern "C" int sweep_bracket_f32(BRACKET_ARGS(float)) { return BRACKET_CALL; }

extern "C" int segsum_f64(const double* x, int rows, int n,
                          const int* offsets, const int* perm, int n_seg,
                          double* out, void* stream) {
  return launch_segsum(x, rows, n, offsets, perm, n_seg, out, stream);
}
extern "C" int segsum_f32(const float* x, int rows, int n, const int* offsets,
                          const int* perm, int n_seg, float* out,
                          void* stream) {
  return launch_segsum(x, rows, n, offsets, perm, n_seg, out, stream);
}
