// Message-free ring halo exchange, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   halo_kernel <- repro/kernels/halo_exchange/halo_exchange.py _halo_kernel
//                  (launched by _ring_exchange_device / ring_halo_exchange)
//
// What it computes: n ranks on a ring each hold a low and a high boundary
// strip of P elements (HPCG's bottom and top z-planes).  Every rank r pushes
// its low strip into its left neighbour's high receive window and its high
// strip into its right neighbour's low receive window:
//   recv_lo[r] = strip_hi[(r - 1) % n]   (from_prev)
//   recv_hi[r] = strip_lo[(r + 1) % n]   (from_next)
//
// The handshake.  On the TPU each rank is a chip, the push is a remote DMA
// into the neighbour's memory, and the handshake is a barrier semaphore
// ("ready to write") followed by the DMA send/recv semaphores ("ready to
// read", the completion wait): the paper's 2 x CXL_ATOMIC_LAT of Eq. 2.  On
// one H100 the card's memory is the pooled memory and a rank is a CTA per
// chunk of its strips (grid = n x chunks).  Both phases are kept: no CTA
// writes into a neighbour's window before that neighbour has signalled
// ready-to-write, and no CTA finishes before both neighbours have signalled
// that its own windows are written.  Every wait is bounded (about one
// second of clock64) and traps when it runs out, so a broken handshake
// fails the run at the next synchronize instead of hanging the card.
//
// What bounds it on an H100: the bytes, each strip read once and each
// window written once (4 x n x P elements): 2.5 us at HPCG's 8 ranks x 256^2
// f32 over 3.35 TB/s, 0.04 us at 8 x 32^2.  Below a few hundred KB an
// exchange is a fixed cost (launch, handshake round trips), so the design
// works on that cost:
//   * Load before the wait.  A CTA's own strips need no permission: it
//     issues their loads into registers (kPrefetch units per strip per
//     thread) before the ready wait, so the handshake's round trip overlaps
//     the read, and stores from registers once the neighbours are ready.
//   * One wave, wide accesses.  The caller sizes chunks so that
//     n x chunks <= the SM count, and moves 16-byte units where the plane
//     size, the rank strides and the base addresses allow it (a scalar
//     unit of the element's width otherwise).  The exchange moves bits, so
//     the unit type does not depend on the float type.
//   * Two routes for the handshake, chosen by the caller from n:
//     - "cluster" (n <= 8, HPCG's ring): one thread-block cluster of n CTAs
//       per chunk, CTA rank r = ring rank r, so a rank's neighbours share
//       its cluster.  Each phase is a remote mbarrier arrive (mapa +
//       mbarrier.arrive.relaxed.cluster; done after one
//       fence.acq_rel.cluster) on both neighbours' barrier in shared memory
//       and an acquire wait on the CTA's own.  Clusters never
//       wait on each other: no global flags, no epochs, an ordinary launch.
//     - "flags" (any n): a cooperative launch, and per (rank, chunk) a
//       ready and a done flag in device memory, each on its own 128-byte
//       line, raised with release adds and polled with acquire loads.  The
//       flags are never reset: the caller passes a call count (epoch) that
//       rises by one per launch on a stream, and each launch adds exactly 2
//       to every flag (n = 1 and n = 2, where left and right coincide,
//       included).
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPrefetch = 4;    // units per strip per thread read before the wait
constexpr int kFlagStride = 16; // 8-byte flags per 128-byte line
// About one second at the H100's boost clock (1.98 GHz).
constexpr long long kSpinCycles = 2000000000LL;

using Flag = unsigned long long;
using FlagRef = cuda::atomic_ref<Flag, cuda::thread_scope_device>;

// A launch's strips and windows, in units U (all offsets in units).
template <typename U>
struct Ring {
  const U* lo;       // rank r's low strip at lo + r * stride_lo
  const U* hi;
  long long stride_lo, stride_hi;
  long long P;       // units per strip
  U* recv_lo;        // contiguous (n, P)
  U* recv_hi;
  int n;
  long long chunk;   // units per CTA
};

// Push this CTA's chunk of rank r's strips into its neighbours' windows:
// the first kPrefetch units per thread are loaded before wait_ready()
// (which ends in a block-wide barrier), the rest after it.
template <typename U, typename Wait>
__device__ __forceinline__ void push(const Ring<U>& g, int r, long long c,
                                     Wait wait_ready) {
  const int left = (r + g.n - 1) % g.n;
  const int right = (r + 1) % g.n;
  const long long begin = c * g.chunk;
  const long long end = begin + g.chunk < g.P ? begin + g.chunk : g.P;
  const U* lo = g.lo + r * g.stride_lo;
  const U* hi = g.hi + r * g.stride_hi;
  U* to_left = g.recv_hi + left * g.P;    // the left neighbour's from_next
  U* to_right = g.recv_lo + right * g.P;  // the right neighbour's from_prev
  U a[kPrefetch], b[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const long long i = begin + threadIdx.x + k * kThreads;
    if (i < end) {
      a[k] = __ldg(lo + i);
      b[k] = __ldg(hi + i);
    }
  }
  wait_ready();
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const long long i = begin + threadIdx.x + k * kThreads;
    if (i < end) {
      to_left[i] = a[k];
      to_right[i] = b[k];
    }
  }
#pragma unroll 4
  for (long long i = begin + kPrefetch * kThreads + threadIdx.x; i < end;
       i += kThreads) {
    to_left[i] = __ldg(lo + i);
    to_right[i] = __ldg(hi + i);
  }
}

// ---------------------------------------------------------------- cluster

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Cluster-wide barrier; the arrive is relaxed, so it does not wait for the
// loads this thread has in flight (the barriers' init is published by
// fence.mbarrier_init before it).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t remote(uint32_t bar, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(bar), "r"(rank));
  return out;
}

// One relaxed arrive on the barrier at the same shared-memory offset in CTA
// `rank` of the cluster.  Ready-to-write publishes nothing, so it needs no
// ordering (nor waits for this thread's loads in flight); done follows one
// fence.acq_rel.cluster that orders the CTA's window stores before both of
// its arrives (a release arrive would fence once per arrive: 0.7-0.9 us more
// per exchange on an H100).
__device__ __forceinline__ void arrive(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(remote(bar, rank)) : "memory");
}

// Wait, with acquire semantics at cluster scope, until the barrier's first
// phase completes; traps after kSpinCycles.
__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  const long long t0 = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
halo_cluster_kernel(Ring<U> g) {
  // [0]: ready-to-write, [1]: done; each completes after two arrivals, one
  // from each neighbour (the same CTA twice when n <= 2).
  __shared__ __align__(8) unsigned long long bars[2];
  uint32_t r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  const long long c = blockIdx.x / g.n;
  const uint32_t left = (r + g.n - 1) % g.n, right = (r + 1) % g.n;
  const uint32_t ready = smem_addr(&bars[0]), done = smem_addr(&bars[1]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;" :: "r"(ready));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;" :: "r"(done));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  push(g, r, c, [&] {
    // every barrier of the cluster is initialised before any remote arrive
    cluster_sync_relaxed();
    if (threadIdx.x == 0) {
      arrive(ready, left);           // 1. ready-to-write to both neighbours
      arrive(ready, right);
      wait_phase0(ready);            //    and both of theirs to this CTA
    }
    __syncthreads();
  });
  // 2. the windows are written: publish, then wait for both neighbours'
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
    arrive(done, left);
    arrive(done, right);
    wait_phase0(done);
  }
}

// ------------------------------------------------------------------ flags

__device__ __forceinline__ void raise_flag(Flag* f) {
  FlagRef(*f).fetch_add(1ull, cuda::memory_order_release);
}

__device__ __forceinline__ void wait_flag(Flag* f, Flag target) {
  FlagRef ref(*f);
  const long long t0 = clock64();
  while (ref.load(cuda::memory_order_acquire) < target) {
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
halo_flags_kernel(Ring<U> g, int chunks, Flag* ready, Flag* done,
                  Flag target) {
  const int r = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int left = (r + g.n - 1) % g.n, right = (r + 1) % g.n;
  auto flag = [&](Flag* f, int rank) {
    return f + (long long)(rank * chunks + c) * kFlagStride;
  };
  if (threadIdx.x == 0) {            // 1. ready-to-write to both neighbours
    raise_flag(flag(ready, left));
    raise_flag(flag(ready, right));
  }
  push(g, r, c, [&] {
    if (threadIdx.x == 0) wait_flag(flag(ready, r), target);
    __syncthreads();
  });
  __threadfence();                   // 2. publish the windows, then wait
  __syncthreads();
  if (threadIdx.x == 0) {
    raise_flag(flag(done, left));
    raise_flag(flag(done, right));
    wait_flag(flag(done, r), target);
  }
}

// ------------------------------------------------------------------ launch

template <typename U>
int max_ctas(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, halo_flags_kernel<U>, kThreads, 0);
  *out = coop ? per_sm * sms : 0;
  return (int)err;
}

enum Route { kCluster = 0, kFlags = 1 };

// The launch geometry: n x chunks CTAs of kThreads on grid x, no dynamic
// shared memory; one cluster of n CTAs per chunk on the cluster route, a
// cooperative launch on the flags route.
struct Plan {
  dim3 grid, block, cluster;
  size_t smem;
  int cooperative;
};

Plan plan(int n, int chunks, int route) {
  return {dim3(n * chunks), dim3(kThreads),
          dim3(route == kCluster ? n : 1), 0, route == kFlags};
}

template <typename U>
int launch(Ring<U> g, int chunks, int route, Flag* flags, long long epoch,
           cudaStream_t stream) {
  g.chunk = (g.P + chunks - 1) / chunks;
  const Plan p = plan(g.n, chunks, route);
  cudaError_t err;
  if (route == kCluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = p.grid;
    cfg.blockDim = p.block;
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster.x;
    attr[0].val.clusterDim.y = p.cluster.y;
    attr[0].val.clusterDim.z = p.cluster.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, halo_cluster_kernel<U>, g);
  } else if (route == kFlags) {
    Flag* ready = flags;
    Flag* done = flags + (long long)g.n * chunks * kFlagStride;
    Flag target = 2ull * (Flag)epoch;
    void* args[] = {&g, &chunks, &ready, &done, &target};
    err = cudaLaunchCooperativeKernel((const void*)halo_flags_kernel<U>,
                                      p.grid, p.block, args, p.smem, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// The attributes of one route's kernel over units U and its CTAs per SM at
// `smem` dynamic bytes, into out[6].
template <typename U>
int attrs(int route, int smem, int* out) {
  cudaFuncAttributes a{};
  int occ = 0;
  const void* kernel = route == kCluster
                           ? (const void*)halo_cluster_kernel<U>
                           : (const void*)halo_flags_kernel<U>;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, smem);
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    a.maxThreadsPerBlock, a.maxDynamicSharedSizeBytes, occ};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}

// T is the float type; with vec the units are 16 bytes (16 / sizeof(T)
// elements), else one element of T's width.
template <typename T, typename Scalar>
int dispatch(const T* strip_lo, const T* strip_hi, long long stride_lo,
             long long stride_hi, long long P, int n, int chunks, int route,
             int vec, T* recv_lo, T* recv_hi, Flag* flags, long long epoch,
             cudaStream_t stream) {
  if (vec) {
    const long long w = 16 / sizeof(T);
    Ring<uint4> g{reinterpret_cast<const uint4*>(strip_lo),
                  reinterpret_cast<const uint4*>(strip_hi), stride_lo / w,
                  stride_hi / w, P / w, reinterpret_cast<uint4*>(recv_lo),
                  reinterpret_cast<uint4*>(recv_hi), n, 0};
    return launch(g, chunks, route, flags, epoch, stream);
  }
  Ring<Scalar> g{reinterpret_cast<const Scalar*>(strip_lo),
                 reinterpret_cast<const Scalar*>(strip_hi), stride_lo,
                 stride_hi, P, reinterpret_cast<Scalar*>(recv_lo),
                 reinterpret_cast<Scalar*>(recv_hi), n, 0};
  return launch(g, chunks, route, flags, epoch, stream);
}

}  // namespace

#define HALO_ARGS(T)                                                       \
  const T *strip_lo, const T *strip_hi, long long stride_lo,               \
      long long stride_hi, long long P, int n, int chunks, int route,      \
      int vec, T *recv_lo, T *recv_hi, unsigned long long *flags,          \
      long long epoch, cudaStream_t stream
#define HALO_CALL(T, Scalar)                                               \
  dispatch<T, Scalar>(strip_lo, strip_hi, stride_lo, stride_hi, P, n,      \
                      chunks, route, vec, recv_lo, recv_hi, flags, epoch,  \
                      stream)

extern "C" int halo_exchange_f64(HALO_ARGS(double)) {
  return HALO_CALL(double, unsigned long long);
}
extern "C" int halo_exchange_f32(HALO_ARGS(float)) {
  return HALO_CALL(float, unsigned int);
}
// out: CTAs of the flags route that the current device holds resident at
// once with 16-byte (vec) or scalar units; 0 without cooperative launches.
extern "C" int halo_max_ctas_f64(int vec, int* out) {
  return vec ? max_ctas<uint4>(out) : max_ctas<unsigned long long>(out);
}
extern "C" int halo_max_ctas_f32(int vec, int* out) {
  return vec ? max_ctas<uint4>(out) : max_ctas<unsigned int>(out);
}

// The geometry the launcher uses for n ranks of P elements in `chunks`
// chunks on `route`, into out[11]: grid xyz, block xyz, dynamic shared
// bytes, cluster xyz, cooperative.
#define HALO_PLAN                                                          \
  if (n < 1 || chunks < 1 || P < 0 || (route != kCluster && route != kFlags)) \
    return (int)cudaErrorInvalidValue;                                     \
  const Plan g = plan(n, chunks, route);                                   \
  const int v[11] = {(int)g.grid.x,    (int)g.grid.y,    (int)g.grid.z,    \
                     (int)g.block.x,   (int)g.block.y,   (int)g.block.z,   \
                     (int)g.smem,      (int)g.cluster.x, (int)g.cluster.y, \
                     (int)g.cluster.z, g.cooperative};                     \
  for (int i = 0; i < 11; ++i) out[i] = v[i];                              \
  return 0
extern "C" int halo_exchange_plan_f64(int n, long long P, int chunks,
                                      int route, int vec, int* out) {
  HALO_PLAN;
}
extern "C" int halo_exchange_plan_f32(int n, long long P, int chunks,
                                      int route, int vec, int* out) {
  HALO_PLAN;
}

// variant = 2 x route + vec: that route's kernel over 16-byte (vec) or
// element units; its attributes and CTAs per SM at `smem`, into out[6]:
// registers, local bytes, static shared bytes, max threads, max dynamic
// shared bytes, occupancy.
extern "C" int halo_exchange_attrs_f64(int variant, int smem, int* out) {
  return variant % 2 ? attrs<uint4>(variant / 2, smem, out)
                     : attrs<unsigned long long>(variant / 2, smem, out);
}
extern "C" int halo_exchange_attrs_f32(int variant, int smem, int* out) {
  return variant % 2 ? attrs<uint4>(variant / 2, smem, out)
                     : attrs<unsigned int>(variant / 2, smem, out);
}
