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
// Design.  On the TPU each rank is a chip, the push is a remote DMA into the
// neighbour's memory, and the handshake is a barrier semaphore ("ready to
// write") followed by the DMA send/recv semaphores ("ready to read", the
// completion wait): the paper's 2 x CXL_ATOMIC_LAT of Eq. 2.  On one H100
// the card's HBM, which every CTA addresses, is the pooled memory: a rank is
// a group of CTAs, each owning one chunk of its rank's strips (grid =
// n x chunks), and the handshake is two flags per (rank, chunk) in device
// memory, raised with release adds and awaited with acquire loads:
//   1. ready-to-write: add 1 to both neighbours' ready flag of this chunk,
//      then wait until this rank's own reaches 2 x epoch;
//   2. push: plain global stores of this chunk into the neighbours' windows
//      (the pooled-memory write);
//   3. ready-to-read / completion: fence, add 1 to both receivers' done flag,
//      then wait until this rank's own reaches 2 x epoch.
// The flags are never reset: the caller passes a call count (epoch) that
// rises by one per launch on a stream, and each launch adds exactly 2 to
// every flag (n = 1 and n = 2, where left and right coincide, included).
// CTAs that wait on each other must be resident together, so the launch is
// cooperative and the caller sizes chunks to the co-resident limit
// (halo_max_ctas).  Every wait is bounded (about one second of clock64) and
// traps when it runs out, so a broken handshake fails the run at the next
// synchronize instead of hanging the card.
//
// What bounds it on an H100: the bytes, each strip read once and each
// window written once (4 x n x P elements); at HPCG's 8 ranks x 256^2 f32
// that is 8.4 MB, 2.5 us at 3.35 TB/s.  The handshake adds two round trips
// through L2 per CTA on top, and the launch itself a few microseconds; a
// simple scalar copy loop is enough for a first kernel that is right.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// About one second at the H100's boost clock (1.98 GHz).
constexpr long long kSpinCycles = 2000000000LL;

using Flag = unsigned long long;
using FlagRef = cuda::atomic_ref<Flag, cuda::thread_scope_device>;

__device__ __forceinline__ void raise_flag(Flag* f) {
  FlagRef(*f).fetch_add(1ull, cuda::memory_order_release);
}

__device__ __forceinline__ void wait_flag(Flag* f, Flag target) {
  FlagRef ref(*f);
  const long long t0 = clock64();
  while (ref.load(cuda::memory_order_acquire) < target) {
    if (clock64() - t0 > kSpinCycles) __trap();
    __nanosleep(64);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_kernel(const T* __restrict__ strip_lo, const T* __restrict__ strip_hi,
            long long stride_lo, long long stride_hi, long long P, int n,
            int chunks, long long chunk_len, T* recv_lo, T* recv_hi,
            Flag* ready, Flag* done, Flag target) {
  const int r = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const int left = (r + n - 1) % n;
  const int right = (r + 1) % n;
  const long long begin = c * chunk_len;
  const long long end = begin + chunk_len < P ? begin + chunk_len : P;

  // 1. receiver ready-to-write: both neighbours reached this point
  if (threadIdx.x == 0) {
    raise_flag(&ready[left * chunks + c]);
    raise_flag(&ready[right * chunks + c]);
    wait_flag(&ready[r * chunks + c], target);
  }
  __syncthreads();

  // 2. push this rank's strips into the neighbours' windows
  const T* lo = strip_lo + r * stride_lo;
  const T* hi = strip_hi + r * stride_hi;
  T* to_left = recv_hi + left * P;     // the left neighbour's from_next
  T* to_right = recv_lo + right * P;   // the right neighbour's from_prev
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    to_left[i] = lo[i];
    to_right[i] = hi[i];
  }

  // 3. ready-to-read: publish the stores, then wait for both neighbours'
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    raise_flag(&done[left * chunks + c]);
    raise_flag(&done[right * chunks + c]);
    wait_flag(&done[r * chunks + c], target);
  }
  __syncthreads();
}

template <typename T>
int max_ctas(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, halo_kernel<T>, kThreads, 0);
  *out = coop ? per_sm * sms : 0;
  return (int)err;
}

template <typename T>
int launch(const T* strip_lo, const T* strip_hi, long long stride_lo,
           long long stride_hi, long long P, int n, int chunks, T* recv_lo,
           T* recv_hi, Flag* flags, long long epoch, cudaStream_t stream) {
  long long chunk_len = (P + chunks - 1) / chunks;
  Flag* ready = flags;
  Flag* done = flags + (long long)n * chunks;
  Flag target = 2ull * (Flag)epoch;
  void* args[] = {&strip_lo, &strip_hi, &stride_lo, &stride_hi, &P, &n,
                  &chunks,   &chunk_len, &recv_lo, &recv_hi, &ready, &done,
                  &target};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)halo_kernel<T>, dim3(n * chunks), dim3(kThreads), args, 0,
      stream);
  cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

#define HALO_ARGS(T)                                                      \
  const T *strip_lo, const T *strip_hi, long long stride_lo,              \
      long long stride_hi, long long P, int n, int chunks, T *recv_lo,    \
      T *recv_hi, unsigned long long *flags, long long epoch,             \
      cudaStream_t stream
#define HALO_CALL                                                         \
  launch(strip_lo, strip_hi, stride_lo, stride_hi, P, n, chunks, recv_lo, \
         recv_hi, flags, epoch, stream)

extern "C" int halo_exchange_f64(HALO_ARGS(double)) { return HALO_CALL; }
extern "C" int halo_exchange_f32(HALO_ARGS(float)) { return HALO_CALL; }
extern "C" int halo_max_ctas_f64(int* out) { return max_ctas<double>(out); }
extern "C" int halo_max_ctas_f32(int* out) { return max_ctas<float>(out); }
