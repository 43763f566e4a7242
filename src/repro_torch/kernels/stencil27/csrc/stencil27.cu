// HPCG's 27-point operator, y = A x over stacked z-slab ranks, written for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's operator
// (repro/apps/hpcg/jax_impl.py apply_a) is plain jnp, which XLA fuses.  The
// port ran it as plain PyTorch (a cat of the ghost planes, a pad, 27
// strided in-place subtractions: about 87 GB of traffic a call at HPCG's
// 8 ranks x 256^3 f64), and that operator was 87% of HPCG's step on the
// card.  This kernel computes the same sum in one pass.
//
// What it computes: n ranks each hold a slab x[r] of (nz, ny, nx) points
// and receive two ghost planes, below[r] (plane z = -1) and above[r]
// (plane z = nz), from the ring exchange.  Outside [0, ny) x [0, nx) every
// value is 0 (Dirichlet).  At each point
//   y = 27 c - sum over (dz, dy, dx) in {-1, 0, 1}^3 of x[z+dz, y+dy, x+dx]
// (the centre included, so the diagonal is 26).  The sum keeps the plain
// version's order, bit for bit: 27 c rounded on its own, then the 27
// subtractions in (dz, dy, dx) order, each rounded (__dmul_rn / __dsub_rn,
// so that nvcc does not contract 27 c - q into an FMA under -O3).
//
// What bounds it on an H100: the bytes.  x with its ghost planes read once
// and y written once is 2.156 GB at 8 x 256^3 f64, 0.6435 ms at 3.35 TB/s.
// The arithmetic is 28 f64 operations a point, about 0.25 ms at the card's
// FP64 rate, and overlaps the loads.  The design keeps shared memory and
// L2 under the byte bound:
//   * 2.5D blocking.  A CTA owns one rank's 32 x 32 tile of the (y, x)
//     plane and marches through a run of z-planes.  Each plane's tile and
//     its one-point halo (34 x 34) is staged into a ring of kStages slots
//     in shared memory with cp.async, kStages - 1 planes ahead of the
//     plane in use, one barrier a plane.  Points outside the plane are
//     zero-filled by the copy itself (source size 0).  Halo rows and
//     columns are the neighbouring tiles' points, which those CTAs read at
//     about the same time: they come from L2.
//   * Nine shared-memory reads a point at most, 4.5 in fact.  A thread owns
//     a column of kRows points in y at one x and keeps, per plane, the
//     (kRows + 2) x 3 values around them in registers.  Moving from plane k
//     to k + 1 reads only plane k + 1's values: it finishes the outputs of
//     plane k - 1 with them, starts those of plane k (27 c, plane k - 1's
//     nine, plane k's nine) and keeps them for the next plane.  So a plane
//     of the tile costs (kRows + 2) x 3 = 18 reads for kRows = 4 outputs,
//     about 0.15 ms a call against the 0.9 ms of reading all 27 neighbours
//     of every point from shared memory.
//   * Enough CTAs at every level.  The grid is (tiles, z-runs, ranks): z is
//     split into runs where the tiles alone are too few, runs of at least
//     kMinRun planes (each run re-reads two planes), until about
//     kTargetCtas CTAs: 4,096 at 256^3 (runs of 32), 2,048 at 128^3.
//   * Coalesced stores: a warp writes 32 consecutive points of a row.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTX = 32;                 // tile width: a warp, a point a lane
constexpr int kWarps = 8;               // threads (kTX, kWarps)
constexpr int kRows = 4;                // rows a thread
constexpr int kTY = kWarps * kRows;     // tile height
constexpr int kThreads = kTX * kWarps;
constexpr int kSX = kTX + 2;            // a staged plane: tile and halo
constexpr int kSY = kTY + 2;
constexpr int kStaged = kSX * kSY;
constexpr int kLoads = (kStaged + kThreads - 1) / kThreads;
constexpr int kStages = 4;              // ring slots; kStages - 1 ahead
constexpr int kTargetCtas = 4096;
constexpr int kMinRun = 8;

template <typename T>
struct Slabs {
  const T* x;        // (n, nz, ny, nx)
  const T* below;    // (n, 1, ny, nx): plane -1 of each rank
  const T* above;    // (n, 1, ny, nx): plane nz of each rank
  T* y;              // (n, nz, ny, nx)
  int nz, ny, nx;
  int tiles_x;       // tiles along x; blockIdx.x = ty * tiles_x + tx
  int run;           // z-planes a run; blockIdx.y is the run
};

// Rounded on their own, never contracted into an FMA.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One element into shared memory; bytes = 0 fills it with zeros.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(smem_addr(dst)), "l"(src), "n"(sizeof(T)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Plane k of rank r, k in [-1, nz]: the ghost planes at both ends.
template <typename T>
__device__ __forceinline__ const T* plane(const Slabs<T>& g, int r, int k) {
  const long long P = (long long)g.ny * g.nx;
  if (k < 0) return g.below + r * P;
  if (k >= g.nz) return g.above + r * P;
  return g.x + ((long long)r * g.nz + k) * P;
}

// a minus the 3 x 3 values around row j of a thread's column, in (dy, dx)
// order.
template <typename T>
__device__ __forceinline__ T minus9(T a, const T (&v)[kRows + 2][3], int j) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) a = sub_rn(a, v[j + dy][dx]);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
stencil27_kernel(Slabs<T> g) {
  __shared__ __align__(16) T ring[kStages][kStaged];
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int r = blockIdx.z;
  const int x0 = (blockIdx.x % g.tiles_x) * kTX;
  const int y0 = (blockIdx.x / g.tiles_x) * kTY;
  const int z0 = blockIdx.y * g.run;
  const int z1 = min(z0 + g.run, g.nz);
  const int m = z1 - z0 + 2;           // planes z0 - 1 .. z1

  // This thread's staged elements: their offsets in a plane, -1 outside it
  // (zero-filled) or past the staged plane.
  int off[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int e = tid + q * kThreads;
    const int gy = y0 - 1 + e / kSX, gx = x0 - 1 + e % kSX;
    off[q] = (e < kStaged && gy >= 0 && gy < g.ny && gx >= 0 && gx < g.nx)
                 ? gy * g.nx + gx : -1;
  }
  auto stage = [&](int i) {            // plane z0 - 1 + i into its slot
    const T* src = plane(g, r, z0 - 1 + i);
    T* dst = ring[i % kStages];
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int e = tid + q * kThreads;
      if (e < kStaged)
        copy_async(dst + e, off[q] >= 0 ? src + off[q] : src,
                   off[q] >= 0 ? (int)sizeof(T) : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < m) stage(i);
    commit();                          // empty groups keep the count
  }

  const int row0 = threadIdx.y * kRows;   // the column's first row in the tile
  const int gx = x0 + threadIdx.x;
  T prev[kRows + 2][3], acc[kRows];
  for (int i = 0; i < m; ++i) {
    wait_groups<kStages - 2>();        // plane i has landed (this thread's)
    __syncthreads();                   // everyone's; slot i - 1 is free
    if (i + kStages - 1 < m) stage(i + kStages - 1);
    commit();
    const T* s = ring[i % kStages] + row0 * kSX + threadIdx.x;
    T cur[kRows + 2][3];
#pragma unroll
    for (int j = 0; j < kRows + 2; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) cur[j][c] = s[j * kSX + c];
    const int k = z0 - 1 + i;          // the plane just read
    if (i >= 2) {                      // plane k - 1's outputs are complete
      T* out = g.y + (((long long)r * g.nz + (k - 1)) * g.ny + y0 + row0) *
                         g.nx + gx;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const T v = minus9(acc[j], cur, j);
        if (gx < g.nx && y0 + row0 + j < g.ny) out[(long long)j * g.nx] = v;
      }
    }
    if (i >= 1 && i <= m - 2) {        // start plane k's outputs
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        acc[j] = minus9(minus9(mul_rn(T(27), cur[j + 1][1]), prev, j), cur,
                        j);
    }
#pragma unroll
    for (int j = 0; j < kRows + 2; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) prev[j][c] = cur[j][c];
  }
}

// ------------------------------------------------------------------ launch

// The launch geometry: (tiles, z-runs, ranks) CTAs of (kTX, kWarps)
// threads, static shared memory only, no cluster.  Runs split z until the
// grid has about kTargetCtas CTAs, each run at least kMinRun planes (or
// the whole slab), every run non-empty.
struct Plan {
  dim3 grid, block;
  int run;
};

Plan plan(int n, int nz, int ny, int nx) {
  const int tiles = ((nx + kTX - 1) / kTX) * ((ny + kTY - 1) / kTY);
  const long long base = (long long)n * tiles;
  long long want = (kTargetCtas + base - 1) / base;
  const int most = nz / kMinRun > 1 ? nz / kMinRun : 1;
  if (want > most) want = most;
  const int run = (int)((nz + want - 1) / want);
  const int runs = (nz + run - 1) / run;
  return {dim3(tiles, runs, n), dim3(kTX, kWarps), run};
}

template <typename T>
int launch(const T* x, const T* below, const T* above, T* y, int n, int nz,
           int ny, int nx, cudaStream_t stream) {
  if (n < 1 || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, nz, ny, nx);
  Slabs<T> g{x, below, above, y, nz, ny, nx, (nx + kTX - 1) / kTX, p.run};
  stencil27_kernel<T><<<p.grid, p.block, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// The kernel's attributes and its CTAs per SM at `smem` dynamic bytes,
// into out[6].
template <typename T>
int attrs(int smem, int* out) {
  cudaFuncAttributes a{};
  int occ = 0;
  const void* kernel = (const void*)stencil27_kernel<T>;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, smem);
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    a.maxThreadsPerBlock, a.maxDynamicSharedSizeBytes, occ};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}

int plan_ints(int n, int nz, int ny, int nx, int* out) {
  if (n < 1 || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, nz, ny, nx);
  const int v[11] = {(int)p.grid.x,  (int)p.grid.y,  (int)p.grid.z,
                     (int)p.block.x, (int)p.block.y, (int)p.block.z,
                     0, 1, 1, 1, 0};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

extern "C" int stencil27_f64(const double* x, const double* below,
                             const double* above, double* y, int n, int nz,
                             int ny, int nx, cudaStream_t stream) {
  return launch(x, below, above, y, n, nz, ny, nx, stream);
}
extern "C" int stencil27_f32(const float* x, const float* below,
                             const float* above, float* y, int n, int nz,
                             int ny, int nx, cudaStream_t stream) {
  return launch(x, below, above, y, n, nz, ny, nx, stream);
}

// The geometry the launcher uses for n ranks of (nz, ny, nx), into out[11]:
// grid xyz, block xyz, dynamic shared bytes, cluster xyz, cooperative.
extern "C" int stencil27_plan_f64(int n, int nz, int ny, int nx, int* out) {
  return plan_ints(n, nz, ny, nx, out);
}
extern "C" int stencil27_plan_f32(int n, int nz, int ny, int nx, int* out) {
  return plan_ints(n, nz, ny, nx, out);
}

// variant (unused: one instantiation a float type); its attributes and CTAs
// per SM at `smem`, into out[6]: registers, local bytes, static shared
// bytes, max threads, max dynamic shared bytes, occupancy.
extern "C" int stencil27_attrs_f64(int variant, int smem, int* out) {
  return attrs<double>(smem, out);
}
extern "C" int stencil27_attrs_f32(int variant, int smem, int* out) {
  return attrs<float>(smem, out);
}
