// One Mamba-2 decode step's state update and readout (granite-4.0-h's
// mixer), written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 (granite is a
// port-only configuration).  The port ran the step as plain PyTorch: the
// state times its decay into a new tensor, a broadcast addcmul_ of
// dt x (x) B into it, an einsum readout (gemv) and about six small kernels
// for the decay, dt x and D x.  That passes five times over each layer's
// float32 state where the work needs two, and was 45% of granite's decode
// step on the card.  This kernel reads the state once and writes it once.
//
// What it computes, per row b of the batch and head h (group g = h / (H/G)):
//   da      = exp(dt[b,h] * -exp(A_log[h]))
//   S'[p,n] = S[p,n] * da + (dt[b,h] * x[b,h,p]) * B[b,g,n]
//   y[p]    = sum_n S'[p,n] * C[b,g,n] + D[h] * x[b,h,p]
// in float32, as the plain version rounds it: the decay and dt x rounded
// on their own (__fmul_rn), S * da rounded, then one fma with B (the
// plain addcmul_).  y's sum runs in another order than the plain
// version's gemv: each lane's four products by an fma chain, then a
// butterfly of warp shuffles over the lanes of a row, then D x added.
// The order is fixed, so y is the same from run to run.  The given state
// is read, never written: S' goes to a new tensor.
//
// What bounds it on an H100: the bytes.  At granite's 256 slots x 128
// heads x (64 x 128) the state is 1.074 GB, read once and written once,
// plus x, dt, B, C in and y out: 2.165 GB, 0.646 ms at 3.35 TB/s.  The
// arithmetic is 5 flops an entry, far under the card's rate.  The design:
//   * One CTA a (b, h) tile of P x N floats (32 KB in and 32 KB out at
//     granite's widths): 32,768 CTAs, grid (H, b).
//   * A row of the tile is N / 4 lanes, each owning four consecutive n as
//     one float4; a warp covers 32 / (N / 4) rows at a time, and a thread
//     holds up to kRows rows in registers (granite: 8 warps of 8 rows, 3
//     CTAs an SM).  A lane keeps its four B and four C in registers for
//     all of them.
//   * Loads first: every thread issues its rows' 16-byte loads of the
//     state, and its rows' x, before any arithmetic; a tile taller than
//     kRows rows a thread is taken kRows at a time.
//   * B and C come in once a CTA, each value by one thread, through 1 KB
//     of shared memory.  The decode's conv output, which they are views
//     of, lies batch-innermost on the card, so each of their values is a
//     sector of its own: fetched by every warp, they took as many L1
//     requests as the state, and the kernel 0.819 ms a call against 0.741
//     with them packed (H100, granite's shape).
//   * The state is read on the read-only path (__ldg) and written with the
//     streaming hint (__stcs): it cannot live in the 50 MB L2 and is not
//     read again until the next step.  On an H100 at granite's shape,
//     __ldcs or __ldlu loads ran 1.5% slower than __ldg; the store's hint
//     moved nothing measurable.
//   * The readout from registers: y[p] is a shuffle sum of the new state
//     as it is stored, so the state makes no second pass.  No atomics.
// The geometry follows the observed P and N (N / 4 lanes a row, a power
// of two up to 32; any P), so the reduced test widths run the same code.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;            // rows a thread holds at once
constexpr int kWarps = 8;           // warps a CTA at most
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 3;       // registers for 3 CTAs an SM
constexpr int kMaxN = 128;          // states a row: 32 lanes of 4

// Strides in elements.  x, dt, B and C are read a float at a time, so
// they take any strides (the conv's output, which they are views of, may
// lie batch-innermost).  The state is read 16 bytes at a time: n is packed
// and each (b, h, p) row starts on a 16-byte boundary, whatever its
// strides (the chunked prefill's final state is strided across b and h).
struct Step {
  const float* ssm;     // (b, H, P, N): strides ssm_b, ssm_h, ssm_p, 1
  const float* x;       // (b, H, P): strides x_b, x_h, x_p
  const float* dt;      // (b, H): strides dt_b, dt_h
  const float* Bm;      // (b, G, N): strides b_b, b_g, b_n
  const float* Cm;      // (b, G, N): strides c_b, c_g, c_n
  const float* A_log;   // (H,)
  const float* D;       // (H,)
  float* out;           // (b, H, P, N) packed: the new state
  float* y;             // (b, H, P) packed
  long long ssm_b, ssm_h, ssm_p, x_b, x_h, x_p, dt_b, dt_h, b_b, b_g, b_n;
  long long c_b, c_g, c_n;
  int H, P, N;
  int heads_per_group;  // H / G
  int lanes;            // N / 4 lanes a row
  int warps;            // warps a CTA
  int passes;           // rows a thread
};

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
mamba2_state_kernel(Step s) {
  __shared__ __align__(16) float bc[2 * kMaxN];     // B, then C, of (b, g)
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / s.lanes;                  // rows a warp at once
  const int sub = lane / s.lanes, col = (lane % s.lanes) * 4;
  const float* src = s.ssm + b * s.ssm_b + h * s.ssm_h + col;
  const float* xs = s.x + b * s.x_b + h * s.x_h;
  const long long row0 = ((long long)b * s.H + h) * s.P;   // y's row of p 0
  float* dst = s.out + row0 * s.N + col;

  // Row p of pass k: (k warps + warp) per_warp + sub.  The passes and
  // their bounds are the same in the CTA; a row's lanes agree on `live`.
  float4 st[kRows];
  float xv[kRows];
  auto load = [&](int k0) {       // passes k0 .. k0 + kRows - 1, and their x
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int p = ((k0 + k) * s.warps + warp) * per_warp + sub;
      if (k0 + k < s.passes && p < s.P) {
        st[k] = __ldg(reinterpret_cast<const float4*>(src + p * s.ssm_p));
        xv[k] = __ldg(xs + p * s.x_p);
      }
    }
  };
  // Loads first: the first passes' rows of the state are in flight while
  // B and C come in, each value by one thread.
  load(0);
  const int g = h / s.heads_per_group;
  const float* bp = s.Bm + b * s.b_b + g * s.b_g;
  const float* cp = s.Cm + b * s.c_b + g * s.c_g;
  for (int i = threadIdx.x; i < 2 * s.N; i += blockDim.x)
    bc[i] = i < s.N ? __ldg(bp + i * s.b_n) : __ldg(cp + (i - s.N) * s.c_n);
  const float dt = __ldg(s.dt + b * s.dt_b + h * s.dt_h);
  const float da = expf(__fmul_rn(dt, -expf(__ldg(s.A_log + h))));
  const float d = __ldg(s.D + h);
  __syncthreads();
  const float4 bv = *reinterpret_cast<const float4*>(bc + col);
  const float4 cv = *reinterpret_cast<const float4*>(bc + s.N + col);

  for (int k0 = 0;;) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k0 + k >= s.passes) break;
      const int p = ((k0 + k) * s.warps + warp) * per_warp + sub;
      const bool live = p < s.P;
      float part = 0.f;
      if (live) {
        const float u = __fmul_rn(dt, xv[k]);
        float4 v = st[k];
        v.x = fmaf(u, bv.x, __fmul_rn(v.x, da));
        v.y = fmaf(u, bv.y, __fmul_rn(v.y, da));
        v.z = fmaf(u, bv.z, __fmul_rn(v.z, da));
        v.w = fmaf(u, bv.w, __fmul_rn(v.w, da));
        __stcs(reinterpret_cast<float4*>(dst + (long long)p * s.N), v);
        part = fmaf(v.w, cv.w, fmaf(v.z, cv.z,
                                    fmaf(v.y, cv.y, __fmul_rn(v.x, cv.x))));
      }
      for (int off = s.lanes >> 1; off > 0; off >>= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (live && lane % s.lanes == 0)
        s.y[row0 + p] = __fadd_rn(part, __fmul_rn(xv[k], d));
    }
    k0 += kRows;
    if (k0 >= s.passes) break;
    load(k0);
  }
}

// ------------------------------------------------------------------ launch

// The launch geometry: (H, b) CTAs of 32 x warps threads, no shared
// memory, no cluster.  A row is N / 4 lanes; warps grow, up to kWarps,
// until each thread has at most kRows rows.  Returns false on a shape the
// kernel does not take: N not 4 x a power of two up to 128.
struct Plan {
  dim3 grid, block;
  int lanes, warps, passes;
};

bool plan(int b, int H, int P, int N, Plan* out) {
  if (b < 1 || H < 1 || P < 1 || N < 4 || N % 4 != 0) return false;
  const int lanes = N / 4;
  if (lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  const int per_warp = 32 / lanes;
  const int slots = (P + per_warp - 1) / per_warp;   // row slots of a CTA
  const int want = (slots + kRows - 1) / kRows;
  const int warps = want < kWarps ? want : kWarps;
  const int passes = (slots + warps - 1) / warps;
  *out = {dim3(H, b), dim3(32 * warps), lanes, warps, passes};
  return true;
}

int launch(const float* ssm, const float* x, const float* dt,
           const float* Bm, const float* Cm, const float* A_log,
           const float* D, float* out, float* y, const long long* strides,
           int b, int H, int P, int N, int G, cudaStream_t stream) {
  Plan p;
  if (G < 1 || H % G != 0 || !plan(b, H, P, N, &p))
    return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  Step s{ssm,   x,     dt,    Bm,    Cm,     A_log,  D,     out,
         y,     t[0],  t[1],  t[2],  t[3],   t[4],   t[5],  t[6],
         t[7],  t[8],  t[9],  t[10], t[11],  t[12],  t[13], H,
         P,     N,     H / G, p.lanes, p.warps, p.passes};
  mamba2_state_kernel<<<p.grid, p.block, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// strides[14], in elements: ssm's (b, h, p); x's (b, h, p); dt's (b, h);
// B's (b, g, n); C's (b, g, n).
extern "C" int mamba2_state_f32(const float* ssm, const float* x,
                                const float* dt, const float* Bm,
                                const float* Cm, const float* A_log,
                                const float* D, float* out, float* y,
                                const long long* strides, int b, int H,
                                int P, int N, int G, cudaStream_t stream) {
  return launch(ssm, x, dt, Bm, Cm, A_log, D, out, y, strides, b, H, P, N,
                G, stream);
}

// The geometry the launcher uses for (b, H, P, N), into out[11]: grid xyz,
// block xyz, dynamic shared bytes, cluster xyz, cooperative.
extern "C" int mamba2_state_plan_f32(int b, int H, int P, int N, int* out) {
  Plan p;
  if (!plan(b, H, P, N, &p)) return (int)cudaErrorInvalidValue;
  const int v[11] = {(int)p.grid.x,  (int)p.grid.y,  (int)p.grid.z,
                     (int)p.block.x, (int)p.block.y, (int)p.block.z,
                     0, 1, 1, 1, 0};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// variant (unused: one instantiation); the kernel's attributes and its CTAs
// per SM at `smem`, into out[6]: registers, local bytes, static shared
// bytes, max threads, max dynamic shared bytes, occupancy (at kThreads,
// granite's block).
extern "C" int mamba2_state_attrs_f32(int variant, int smem, int* out) {
  cudaFuncAttributes a{};
  int occ = 0;
  const void* kernel = (const void*)mamba2_state_kernel;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, smem);
  const int v[6] = {a.numRegs, (int)a.localSizeBytes, (int)a.sharedSizeBytes,
                    a.maxThreadsPerBlock, a.maxDynamicSharedSizeBytes, occ};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)err;
}
