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
// sample-block grid axis.  Both are TPU artefacts.  Here:
//   * The grid walks scenario tiles only: a persistent grid of a few CTAs
//     per SM, each taking tiles of kTile scenarios over *all* sites, so
//     delta and cxl are read once and a tile's outputs are one contiguous
//     (rows, n_seg) block of each of the four matrices.  A tile takes one
//     pass over the sites per output (miss, lfb_half, lfb_mem, hit).
//   * The bundle sits in shared memory, loaded once per CTA: ops.csr_group
//     prepares each group's samples already in site (CSR) order, packed as
//     (lat, w) pairs, so there is no permutation gather.  The CTA's threads
//     copy the pairs, and the sites' CSR offsets and (min, max) lat, after
//     issuing the first tile's delta and cxl loads, so the latencies
//     overlap.  (A cp.async.bulk copy on an mbarrier, timed in its place
//     on an H100, cost about 4 us more per launch.)  A bundle above the
//     caller's shared-memory budget takes the tiled path: each site's
//     pairs are staged through a window of kWindow pairs.
//   * Each thread owns kSPT scenarios, so one broadcast 16-byte shared
//     load of a pair feeds kSPT independent FMA chains, and the walk takes
//     samples in blocks of four: a block's loads and adds issue ahead of
//     its FMAs, which keep the CSR order per chain.
//   * max(lat + d, 0) costs no float64 instruction: the sum only takes
//     terms whose sign bit is clear (an integer test of the high word and a
//     predicated DFMA), so a term costs one DADD and one DFMA.  (DMNMX
//     issues at a quarter of the DFMA rate on an H100, and a DSETP + FSEL
//     select adds a compare per term.)  Where a site's (min, max) lat
//     (from ops.csr_group) puts every term of the warp's scenarios on one
//     side, the test goes too (all kept) or the terms do (none kept): the
//     same bits, fewer instructions.  The miss bracket keeps its compare:
//     max(cxl, lat + d) has no zero side.
//   * A pass's sums of a chunk of sites are staged in shared memory, in a
//     ring of two buffers, and leave as one bulk copy (cp.async.bulk
//     shared -> global) of the contiguous block, issued by one thread while
//     the others go on summing; instead of 8-byte stores n_seg apart
//     between neighbouring threads.
// Each (s, c) sums its site's samples in CSR order in one thread with no
// atomics, so the result is deterministic and a scenario's row does not
// depend on which other scenarios share the launch (chunking the scenario
// axis is bit-identical).
//
// What bounds it on an H100: at the main path's S = 262,144 scenarios,
// n_seg = 4 and 192 + 64 samples, the writes of four (S, n_seg) float64
// arrays (11.3 us at 3.35 TB/s); the float64 pipe (64 lanes per SM per
// clock) needs S x (2 x 192 + 4 x 64) DADD/DFMA, about 10 us.  Measured
// on an H100 the walk's pattern (a shared load, DADDs and DFMAs) reaches
// only 37-54 of the 64 lanes, so the walk alone takes 15-18 us.
//
// segsum_kernel: x (rows, n) row-major and CSR offsets over the n columns
// give out (rows, n_seg); one thread per row, columns summed in CSR order.
//
// Each extern "C" launcher enqueues on the given stream, allocates nothing,
// and returns a CUDA error code so the caller can raise on a refused launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlock = 128;      // segsum_kernel: threads per block, a row each
constexpr int kThreads = 128;    // bracket_kernel: threads per CTA
constexpr int kSPT = 4;          // scenarios per thread
constexpr int kTile = kThreads * kSPT;
constexpr int kStageBytes = 32 * 1024;   // two chunks of a pass's sums
constexpr int kResidentBytes = 48 * 1024;  // the largest bundle kept whole
constexpr int kWindow = 512;     // pairs per step of the tiled path
constexpr int kMetaSites = 256;  // most sites whose offsets and bounds are
                                 // copied to shared memory
constexpr int kMaxDevices = 64;

template <typename T> struct PairOf;
template <> struct PairOf<double> { using type = double2; };
template <> struct PairOf<float> { using type = float2; };

template <typename T>
struct Group {
  const typename PairOf<T>::type* pairs;  // (lat, w) in site order, padded
  const int* offsets;                     // (n_seg + 1,) CSR offsets
  const typename PairOf<T>::type* bounds; // (n_seg,) (min, max) lat per site
  int n;                                  // pairs, an even count
};

template <typename T>
struct Bracket {
  Group<T> g[3];            // hit, lfb, miss
  const T* delta;
  const T* cxl;
  int S, n_seg;
  int cs;                   // sites per staged chunk
  int meta;                 // offsets and bounds copied to shared memory
  T* out[4];                // hit_degraded, lfb_mem, lfb_half, miss_congested
};

template <typename T>
__device__ __forceinline__ T maxv(T a, T b) { return a > b ? a : b; }

// Sign bit clear: x >= +0, the terms max(x, 0) keeps (a -0 term adds
// nothing either way).
__device__ __forceinline__ bool keep(double x) { return __double2hiint(x) >= 0; }
__device__ __forceinline__ bool keep(float x) { return __float_as_int(x) >= 0; }

template <int N>
using Int = std::integral_constant<int, N>;

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory for the three groups' offsets and bounds of n_seg sites.
template <typename P>
constexpr size_t meta_bytes(int n_seg) {
  return 3 * (align16((n_seg + 1) * sizeof(int)) +
              align16(n_seg * sizeof(P)));
}

// How the terms max(lat + s, 0) of site c fall for every scenario of the
// warp (shift s = d or d / 2), from the site's (min, max) lat: all kept (no
// test), none kept (no walk, where the pairs are resident), or mixed (a
// test per term).  Exact: lat + s rounds monotonically, so the extremes
// decide the sign of every term.
enum Kind { kMixed, kAll, kNone };

template <typename T, typename P>
__device__ __forceinline__ int kind(const P* bounds, int c, const T* s) {
  const P b = bounds[c];
  bool all = true, none = true;
#pragma unroll
  for (int k = 0; k < kSPT; ++k) {
    all = all && keep(b.x + s[k]);
    none = none && !keep(b.y + s[k]);
  }
  return __all_sync(~0u, all) ? kAll : __all_sync(~0u, none) ? kNone : kMixed;
}

// A CTA-wide barrier that warps may reach from different call sites (the
// walks a warp-uniform Kind selects); every thread arrives equally often.
__device__ __forceinline__ void barrier_any_site() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

// f(Int<U>, q) for the samples of site c of a group, in CSR order, in blocks
// of U consecutive pairs q[0 .. U) and single pairs for the rest: from the
// resident copy, or staged through `window`, whose barriers every warp
// must reach alike (so on the tiled path every warp walks every site).
template <bool kResident, int U, typename P, typename F>
__device__ __forceinline__ void walk(const P* resident, P* window,
                                     const P* pairs, const int* offsets,
                                     int c, F f) {
  const int b = offsets[c], e = offsets[c + 1];
  auto run = [&](const P* q, int m) {
    int j = 0;
    for (; j + U <= m; j += U) f(Int<U>{}, q + j);
    for (; j < m; ++j) f(Int<1>{}, q + j);
  };
  if constexpr (kResident) {
    run(resident + b, e - b);
  } else {
    for (int base = b; base < e; base += kWindow) {
      const int m = min(kWindow, e - base);
      barrier_any_site();  // the previous window has been consumed
      for (int j = threadIdx.x; j < m; j += kThreads)
        window[j] = pairs[base + j];
      barrier_any_site();
      run(window, m);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The stage's chunks leave for device memory through a ring of two
// buffers.  Each chunk is written by every thread, then after one barrier
// stored: one bulk copy (cp.async.bulk shared -> global) issued by thread
// 0 when the chunk is one contiguous, 16-byte aligned block, else by every
// thread element by element.  Before that barrier thread 0 waits until the
// previous chunk's bulk copy has read its buffer, the one the next chunk
// writes, so the threads go on summing while the copies run.
template <typename T>
struct Stage {
  T* buf[2];            // (kTile, cs) each
  int turn = 0;

  template <typename Site>
  __device__ __forceinline__ void chunk(const Bracket<T>& p, int s0,
                                        int rows, T* out, int c0, int cw,
                                        Site site) {
    const int cs = p.cs;
    T* st = buf[turn];
    turn ^= 1;
    for (int cc = 0; cc < cw; ++cc)
      site(c0 + cc, [&](int k, T v) {
        st[(threadIdx.x + k * kThreads) * cs + cc] = v;
      });
    // this thread's writes are visible to the bulk copy's (async) proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncthreads();
    const long long at = (long long)s0 * p.n_seg;
    const int bytes = rows * cw * (int)sizeof(T);
    if (cw == p.n_seg && bytes % 16 == 0) {
      if (threadIdx.x == 0) {
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
            :: "l"(out + at), "r"(smem_addr(st)), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
      return;
    }
    for (int e = threadIdx.x; e < rows * cw; e += kThreads) {
      const int i = e / cw, cc = e % cw;
      out[(long long)(s0 + i) * p.n_seg + c0 + cc] = st[i * cs + cc];
    }
  }

  // One pass over the sites in chunks of p.cs: site(c, put) sums site c
  // and hands this thread's k-th sum to put(k, v).
  template <typename Site>
  __device__ __forceinline__ void pass(const Bracket<T>& p, int s0,
                                       int rows, T* out, Site site) {
    for (int c0 = 0; c0 < p.n_seg; c0 += p.cs)
      chunk(p, s0, rows, out, c0, min(p.cs, p.n_seg - c0), site);
  }

  // Every bulk copy has landed before the CTA exits.
  __device__ __forceinline__ void drain() {
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
};

template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads)
bracket_kernel(Bracket<T> p) {
  using P = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage<T> stage;
  stage.buf[0] = reinterpret_cast<T*>(smem);
  stage.buf[1] = stage.buf[0] + kTile * p.cs;
  unsigned char* next = smem + 2 * kTile * p.cs * sizeof(T);
  // each group's offsets and bounds: in shared memory after the stage when
  // there are few sites, read in place otherwise; then the pairs (or the
  // window)
  const int* offs[3];
  const P* bnds[3];
#pragma unroll
  for (int gi = 0; gi < 3; ++gi) {
    offs[gi] = p.g[gi].offsets;
    bnds[gi] = p.g[gi].bounds;
    if (p.meta) {
      offs[gi] = reinterpret_cast<const int*>(next);
      next += align16((p.n_seg + 1) * sizeof(int));
      bnds[gi] = reinterpret_cast<const P*>(next);
      next += align16(p.n_seg * sizeof(P));
    }
  }
  P* pairs = reinterpret_cast<P*>(next);
  const P* res[3] = {pairs, pairs + p.g[0].n, pairs + p.g[0].n + p.g[1].n};

  bool first = true;
  const int tiles = (p.S + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int s0 = tile * kTile;
    const int rows = min(kTile, p.S - s0);
    T d[kSPT], h[kSPT], x[kSPT];
#pragma unroll
    for (int k = 0; k < kSPT; ++k) {
      const int i = threadIdx.x + k * kThreads;
      d[k] = i < rows ? p.delta[s0 + i] : T(0);
      x[k] = i < rows ? p.cxl[s0 + i] : T(0);
    }
    if (first) {
      // the bundle, copied once per CTA while the first tile's loads are
      // in flight
      first = false;
#pragma unroll
      for (int gi = 0; gi < 3; ++gi) {
        if (p.meta) {
          int* o = const_cast<int*>(offs[gi]);
          P* bb = const_cast<P*>(bnds[gi]);
          for (int j = threadIdx.x; j <= p.n_seg; j += kThreads)
            o[j] = p.g[gi].offsets[j];
          for (int j = threadIdx.x; j < p.n_seg; j += kThreads)
            bb[j] = p.g[gi].bounds[j];
        }
        if (kResident) {
          P* dst = const_cast<P*>(res[gi]);
          for (int j = threadIdx.x; j < p.g[gi].n; j += kThreads)
            dst[j] = p.g[gi].pairs[j];
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kSPT; ++k) h[k] = d[k] * T(0.5);

    // sum over group gi's samples at site c of w * max(lat + sh, 0): one
    // DADD and one DFMA per term, the DFMA predicated only where the site's
    // terms are mixed; blocks of four samples keep a block's loads and adds
    // ahead of its FMAs
    auto clamped = [&](int gi, const T (&sh)[kSPT], int c, auto put) {
      T a[kSPT];
#pragma unroll
      for (int k = 0; k < kSPT; ++k) a[k] = T(0);
      auto terms = [&](auto U, const P* q, auto test) {
        constexpr int n = decltype(U)::value;
        P s[n];
        T v[n][kSPT];
#pragma unroll
        for (int u = 0; u < n; ++u) s[u] = q[u];
#pragma unroll
        for (int u = 0; u < n; ++u)
#pragma unroll
          for (int k = 0; k < kSPT; ++k) v[u][k] = s[u].x + sh[k];
#pragma unroll
        for (int u = 0; u < n; ++u)
#pragma unroll
          for (int k = 0; k < kSPT; ++k)
            if (!decltype(test)::value || keep(v[u][k]))
              a[k] = fma(s[u].y, v[u][k], a[k]);
      };
      const int kd = kind(bnds[gi], c, sh);
      if (kd == kAll)
        walk<kResident, 4>(res[gi], pairs, p.g[gi].pairs, offs[gi], c,
                           [&](auto U, const P* q) {
          terms(U, q, std::false_type{});
        });
      else if (kd == kMixed || !kResident)
        walk<kResident, 4>(res[gi], pairs, p.g[gi].pairs, offs[gi], c,
                           [&](auto U, const P* q) {
          terms(U, q, std::true_type{});
        });
#pragma unroll
      for (int k = 0; k < kSPT; ++k) put(k, a[k]);
    };
    // One pass per output; miss, then LFB, then hit, so that the stores
    // still in flight when the last pass ends are the hit matrix's.
    // miss_congested: max(cxl, lat + d) has no zero side, so it keeps its
    // compare
    stage.pass(p, s0, rows, p.out[3], [&](int c, auto put) {
      T a[kSPT];
#pragma unroll
      for (int k = 0; k < kSPT; ++k) a[k] = T(0);
      walk<kResident, 1>(res[2], pairs, p.g[2].pairs, offs[2], c,
                         [&](auto, const P* q) {
        const P s = *q;
#pragma unroll
        for (int k = 0; k < kSPT; ++k)
          a[k] = fma(s.y, maxv(x[k], s.x + d[k]), a[k]);
      });
#pragma unroll
      for (int k = 0; k < kSPT; ++k) put(k, a[k]);
    });
    stage.pass(p, s0, rows, p.out[2],           // lfb_half
               [&](int c, auto put) { clamped(1, h, c, put); });
    stage.pass(p, s0, rows, p.out[1],           // lfb_mem
               [&](int c, auto put) { clamped(1, d, c, put); });
    stage.pass(p, s0, rows, p.out[0],           // hit_degraded
               [&](int c, auto put) { clamped(0, d, c, put); });
  }
  stage.drain();
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

// The launch geometry of both kernels: a grid on x (and, for segsum, the
// segment on y), no cluster, no cooperative launch.
struct Plan {
  dim3 grid, block;
  size_t smem;
};

void put(const Plan& g, int* out) {
  const int v[11] = {(int)g.grid.x, (int)g.grid.y, (int)g.grid.z,
                     (int)g.block.x, (int)g.block.y, (int)g.block.z,
                     (int)g.smem, 1, 1, 1, 0};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

// The dynamic shared memory of a launch over n_seg sites and n_pairs
// pairs: the stage's two buffers of (kTile, cs), the sites' metadata when
// n_seg <= kMetaSites, then the pairs (resident) or the window.
template <typename T>
size_t bracket_smem(int n_seg, int n_pairs, int resident, int* cs,
                    int* meta) {
  using P = typename PairOf<T>::type;
  *cs = min(n_seg, kStageBytes / (2 * kTile * (int)sizeof(T)));
  *meta = n_seg <= kMetaSites;
  const size_t fixed = (size_t)2 * kTile * *cs * sizeof(T) +
                       (*meta ? meta_bytes<P>(n_seg) : 0);
  return fixed + (resident ? (size_t)n_pairs * sizeof(P)
                           : (size_t)kWindow * sizeof(P));
}

// A persistent grid: the scenario tiles, at most occ CTAs per SM.
Plan bracket_plan(int S, size_t smem, int sms, int occ) {
  const int tiles = (S + kTile - 1) / kTile;
  return {dim3(min(tiles, max(1, occ) * sms)), dim3(kThreads), smem};
}

// The device's SM count and the kernel's CTAs per SM at smem bytes, asked
// once per device (and again when smem changes); the first call also
// raises the kernel's dynamic shared memory limit to the most any launch
// takes.
template <typename T, bool kResident>
cudaError_t occupancy(size_t smem, int* sms_out, int* occ_out) {
  auto kernel = bracket_kernel<T, kResident>;
  // per device: the SM count and the CTAs per SM at the last smem size
  static int sms[kMaxDevices], occ[kMaxDevices];
  static size_t occ_smem[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes + kResidentBytes +
                                   meta_bytes<double2>(kMetaSites));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
  }
  if (occ_smem[dev] != smem || occ[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    occ_smem[dev] = smem;
  }
  *sms_out = sms[dev];
  *occ_out = occ[dev];
  return cudaSuccess;
}

template <typename T, bool kResident>
int launch_bracket(const Bracket<T>& p, size_t smem, cudaStream_t stream) {
  int sms = 0, occ = 0;
  cudaError_t err = occupancy<T, kResident>(smem, &sms, &occ);
  if (err != cudaSuccess) return (int)err;
  const Plan g = bracket_plan(p.S, smem, sms, occ);
  bracket_kernel<T, kResident><<<g.grid, g.block, g.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int bracket(Group<T> hit, Group<T> lfb, Group<T> miss, const T* delta,
            const T* cxl, int S, int n_seg, int resident, T* o_hit,
            T* o_lmem, T* o_lhalf, T* o_mcong, void* stream) {
  using P = typename PairOf<T>::type;
  Bracket<T> p{{hit, lfb, miss}, delta, cxl, S, n_seg, 0, 0,
               {o_hit, o_lmem, o_lhalf, o_mcong}};
  const int n_pairs = hit.n + lfb.n + miss.n;
  const size_t smem = bracket_smem<T>(n_seg, n_pairs, resident, &p.cs,
                                      &p.meta);
  if (resident) {
    if ((size_t)n_pairs * sizeof(P) > (size_t)kResidentBytes)
      return (int)cudaErrorInvalidValue;
    return launch_bracket<T, true>(p, smem, (cudaStream_t)stream);
  }
  return launch_bracket<T, false>(p, smem, (cudaStream_t)stream);
}

// The geometry the launcher uses, into out[11], and the SM count and CTAs
// per SM it took from the card into out[11], out[12].
template <typename T>
int bracket_plan_c(int S, int n_seg, int n_pairs, int resident, int* out) {
  int cs = 0, meta = 0, sms = 0, occ = 0;
  const size_t smem = bracket_smem<T>(n_seg, n_pairs, resident, &cs, &meta);
  cudaError_t err = resident ? occupancy<T, true>(smem, &sms, &occ)
                             : occupancy<T, false>(smem, &sms, &occ);
  if (err != cudaSuccess) return (int)err;
  put(bracket_plan(S, smem, sms, occ), out);
  out[11] = sms;
  out[12] = occ;
  return 0;
}

// A kernel's attributes and its CTAs per SM at smem dynamic bytes, into
// out[6].
template <typename K>
int read_attrs(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a{};
  int occ = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        threads, smem);
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    a.maxThreadsPerBlock, a.maxDynamicSharedSizeBytes, occ};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}

// variant 0: the tiled bracket kernel, 1: the resident one (the dynamic
// shared memory limit raised as the launcher raises it), 2: segsum.
template <typename T>
int attrs(int variant, int smem, int* out) {
  int sms = 0, occ = 0;
  cudaError_t err;
  switch (variant) {
    case 0:
      err = occupancy<T, false>(smem, &sms, &occ);
      if (err != cudaSuccess) return (int)err;
      return read_attrs(bracket_kernel<T, false>, kThreads, smem, out);
    case 1:
      err = occupancy<T, true>(smem, &sms, &occ);
      if (err != cudaSuccess) return (int)err;
      return read_attrs(bracket_kernel<T, true>, kThreads, smem, out);
    case 2:
      return read_attrs(segsum_kernel<T>, kBlock, smem, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Plan segsum_plan(int rows, int n_seg) {
  return {dim3((rows + kBlock - 1) / kBlock, n_seg), dim3(kBlock), 0};
}

template <typename T>
int launch_segsum(const T* x, int rows, int n, const int* offsets,
                  const int* perm, int n_seg, T* out, void* stream) {
  const Plan g = segsum_plan(rows, n_seg);
  segsum_kernel<T><<<g.grid, g.block, g.smem, (cudaStream_t)stream>>>(
      x, rows, n, offsets, perm, n_seg, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Each group is (pairs, offsets, bounds, n): n (lat, w) pairs in site
// order, 16-byte aligned and padded to an even count, n_seg + 1 CSR offsets
// and n_seg (min, max) lat pairs.
#define BRACKET_ARGS(T)                                                      \
  const void *hp, const int *ho, const void *hb, int hn, const void *lp,     \
      const int *lo, const void *lb, int ln, const void *mp, const int *mo,  \
      const void *mb, int mn, const T *delta, const T *cxl, int S,           \
      int n_seg, int resident, T *o_hit, T *o_lmem, T *o_lhalf,             \
      T *o_mcong, void *stream
#define BRACKET_CALL(T)                                                      \
  using P = PairOf<T>::type;                                                 \
  return bracket<T>(Group<T>{(const P*)hp, ho, (const P*)hb, hn},            \
                    Group<T>{(const P*)lp, lo, (const P*)lb, ln},            \
                    Group<T>{(const P*)mp, mo, (const P*)mb, mn}, delta,     \
                    cxl, S, n_seg, resident, o_hit, o_lmem, o_lhalf,         \
                    o_mcong, stream)

extern "C" int sweep_bracket_f64(BRACKET_ARGS(double)) { BRACKET_CALL(double); }
extern "C" int sweep_bracket_f32(BRACKET_ARGS(float)) { BRACKET_CALL(float); }

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

// The launch geometry of S scenarios over n_seg sites and n_pairs pairs
// (the three groups' together), into out[13]: grid xyz, block xyz, dynamic
// shared bytes, cluster xyz, cooperative, then the SM count and CTAs per
// SM the persistent grid was sized with.
extern "C" int sweep_bracket_plan_f64(int S, int n_seg, int n_pairs,
                                      int resident, int* out) {
  return bracket_plan_c<double>(S, n_seg, n_pairs, resident, out);
}
extern "C" int sweep_bracket_plan_f32(int S, int n_seg, int n_pairs,
                                      int resident, int* out) {
  return bracket_plan_c<float>(S, n_seg, n_pairs, resident, out);
}
// variant 0: bracket_kernel tiled, 1: resident; its attributes and CTAs
// per SM at `smem`, into out[6]: registers, local bytes, static shared
// bytes, max threads, max dynamic shared bytes, occupancy.
extern "C" int sweep_bracket_attrs_f64(int variant, int smem, int* out) {
  return attrs<double>(variant, smem, out);
}
extern "C" int sweep_bracket_attrs_f32(int variant, int smem, int* out) {
  return attrs<float>(variant, smem, out);
}
// segsum_kernel's geometry for (rows, n) -> n_seg, into out[11].
extern "C" int segsum_plan_f64(int rows, int n, int n_seg, int* out) {
  put(segsum_plan(rows, n_seg), out);
  return 0;
}
extern "C" int segsum_plan_f32(int rows, int n, int n_seg, int* out) {
  put(segsum_plan(rows, n_seg), out);
  return 0;
}
extern "C" int segsum_attrs_f64(int variant, int smem, int* out) {
  return variant == 0 ? attrs<double>(2, smem, out)
                      : (int)cudaErrorInvalidValue;
}
extern "C" int segsum_attrs_f32(int variant, int smem, int* out) {
  return variant == 0 ? attrs<float>(2, smem, out)
                      : (int)cudaErrorInvalidValue;
}
