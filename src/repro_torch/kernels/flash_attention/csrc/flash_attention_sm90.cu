// Blockwise (flash) attention on Hopper's tensor cores (sm_90a): bf16 wgmma,
// TMA loads and a warp-specialised kv pipeline.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   attn_sm90_kernel <- repro/kernels/flash_attention/flash_attention.py
//                       _attn_kernel (launched by flash_attention_bhsd)
// for bf16 inputs at head widths D = 64, 128 and 256.  float32 inputs and
// bf16 at D = 16 and 32 stay on attn_kernel in flash_attention.cu.
//
// What it computes: for q (B, S, Hq, D) and k, v (B, T, Hkv, D), query head
// h attends over kv head h / (Hq / Hkv) (GQA by index):
//   out[b, s, h] = softmax_t(scale * q[b, s, h] . k[b, t, h/g]) v[b, t, h/g]
// with scale = 1 / sqrt(D), positions t > s + q_offset masked when causal
// (q_offset: the position of q's first row among the keys, nonzero where q
// is a later block of the sequence than k and v begin with), and the
// output in bf16.  As in the TPU kernel, masked scores take the -1e30
// sentinel, the online softmax keeps (m, l, acc) in f32 with its safe-max
// guards, every kv tile wholly above the diagonal is skipped and only the
// tiles that cross it are masked; ragged S and T are masked too.
//
// Rounding: both products take bf16 operands and accumulate in f32.  Q K^T
// reads the bf16 inputs as they are; P V rounds the probabilities P to bf16
// first (the f32 row sums l are kept from the unrounded P).  The reference
// (and attn_kernel) keeps P in f32, so each output departs from it by about
// one bf16 rounding of P, relative 2^-9 per term, averaged over the row.
//
// What bounds it on an H100: at the LM's shape (B 2, S = T 4096, 32 q / 8 kv
// heads of 128, causal) the work is 2.75e11 operations on 168 MB, so the
// bf16 tensor-core rate bounds it (0.28 ms at 989 TFLOP/s).  Reaching that
// needs wgmma (the only path to the full rate), operands in shared memory
// in the layout wgmma reads without bank conflicts, and loads that overlap
// the math.
//
// Design (after FlashAttention-3's forward pass).  One CTA of 384 threads
// owns 128 q rows of one (batch, q head): warpgroups 0 and 1 (the
// consumers) each own 64 of the rows, and warpgroup 2 is the producer.
// CTAs are launched longest q block first.
//   - Loads: TMA, one thread of the producer.  Q comes once; K and V
//     tiles of kBK rows come through a ring in shared memory (three stages
//     for D <= 128, two for D = 256, within the 227 KB a CTA can have),
//     each stage with a "full" mbarrier per operand (TMA completes it by
//     bytes) and an "empty" one per operand (the 8 consumer warps arrive),
//     so K is released as soon as S is computed and the next tiles are in
//     flight while the consumers compute.  The tensor maps give S (or T) a
//     dimension of its own in (D, H, S, B) order, so a ragged last tile
//     reads zeros, never the next batch row's q or kv.  The encoder
//     (cuTensorMapEncodeTiled) is taken through cudaGetDriverEntryPoint, so
//     the library links no -lcuda.
//   - Layout: every tile is stored as D/64 column blocks of rows x 128 bytes
//     with the 128-byte swizzle, the same swizzle in the tensor maps and in
//     the wgmma descriptors; tiles start on 1024-byte boundaries.
//   - S = Q K^T: wgmma m64n{kBK}k16 with both operands K-major in shared
//     memory (K's row-major (kv, D) tile is the natural B), f32 in
//     registers.  Softmax on those registers: each thread holds two rows,
//     reduced over the four threads of a quad.
//   - O += P V: P converted to bf16 in registers, where S's accumulator
//     layout is exactly wgmma's A-fragment layout; V's row-major (kv, D)
//     tile is an MN-major B (the transpose bit).  wgmma m64n{D}k16.
//   - Registers: setmaxnreg moves them from the producer (40) to the
//     consumers (232).  O takes D / 2 f32 registers per thread and S kBK / 2,
//     so kBK is 128 for D <= 128 and 64 for D = 256.
//   - Softmax: m is kept in unscaled score units, so a probability costs
//     one FFMA and one ex2; only the tiles that cross the diagonal or T run
//     the masked version with the sentinel and the safe-max guards.  Every
//     loop is straight-line code around its wgmmas (tiles that need the
//     mask run in a loop of their own), because a branch between a wgmma
//     and its wait makes ptxas serialise all of them.
//   - Overlap: the two consumer warpgroups run side by side, so one's
//     softmax hides under the other's products.  Overlapping the softmax of
//     tile i with O += P V of tile i - 1 inside a warpgroup (a second
//     accumulator group in flight) measured no faster at the LM's shape.
//   - Ordering: wgmma.fence before every batch of wgmmas (their
//     accumulators or P were written by ordinary code); after each
//     wait_group 0, a register fence on the accumulators it completed (so
//     no read moves above it) and on P.
//
// ptxas (-Xptxas -v, nvcc 12.9, sm_90a): see PERF.md for the registers and
// spills of each instantiation.
//
// Each extern "C" entry allocates nothing, enqueues on the given stream and
// returns a CUDA error code (0 on success) so the caller can raise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                  // q rows per CTA
constexpr int kWG = 128;                  // threads per warpgroup
constexpr int kThreads = 3 * kWG;         // two consumers + a producer
constexpr int kRowBytes = 128;            // one swizzled row of 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static constexpr int kBK = D > 128 ? 64 : 128;   // kv rows per tile
  static constexpr int kStages = D > 128 ? 2 : 3;  // K/V ring depth
  static constexpr int kCols = D / 64;             // 128-byte column blocks
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;     // one K or V tile
  // 1024-byte alignment pad, Q, the K and V rings, the mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 4 * kStages) * 8;
};

// ----------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
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

// One TMA box of a 4-d tensor map into shared memory, completing ``bar``
// by its bytes (zeros where the box leaves the tensor).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of accumulator registers above the
// wgmma.wait_group that makes them valid.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// Keeps P's registers live (and unreused) until the wgmma reading them is
// done.
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- wgmma (bf16 -> f32)
// S (64 x 64) [+]= A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// S (64 x 128) [+]= A (64 x 16, smem) . B (128 x 16, smem)^T, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x 64) [+]= P (64 x 16, registers) . V (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, "
      "0;\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// O (64 x 128) [+]= P (64 x 16, registers) . V (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// O (64 x 256) [+]= P (64 x 16, registers) . V (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, "
      "0;\nwgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "head width");
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b, scale_d);
  else wgmma_rs_n256(d, a, b, scale_d);
}

// -------------------------------------------------------------- kernel
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// One consumer warpgroup: its 64 q rows, its registers (O, S, P and the
// softmax carry), and the loops over the CTA's kv tiles.  Every loop body
// is straight-line code around the wgmmas, so the compiler can track which
// wgmma groups are in flight (a branch there makes it serialise them).
template <int D>
struct Consumer {
  static constexpr int kBK = Shape<D>::kBK;
  static constexpr int kKVBytes = Shape<D>::kKVBytes;
  static constexpr int kStages = Shape<D>::kStages;
  const uint8_t* qw;   // this warpgroup's 64 q rows, column block 0
  const uint8_t* ks;   // the K ring
  const uint8_t* vs;   // the V ring
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
  int first;           // the warpgroup's first q position
  int row0;            // this thread's rows: row0 and row0 + 8
  int quad;
  int Tk;
  int causal;
  int q_off;           // q row s sits at key position s + q_off
  float scale_log2;
  float acc[D / 2];    // O, wgmma m64n{D} accumulator layout
  float s[kBK / 2];    // S, then P in f32
  uint32_t p[kBK / 4]; // P in bf16, as wgmma A fragments
  float m[2], l[2];    // running max (log2 units), this thread's row sums

  // S = Q K^T over D, 16 columns of D per wgmma (issued, not waited on)
  __device__ __forceinline__ void issue_s(int st) {
    const uint8_t* kt = ks + st * kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < Shape<D>::kCols; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kBK>(
            s, gmma_desc(qw + c * kBQ * kRowBytes + 32 * kk, 16, 1024),
            gmma_desc(kt + c * kBK * kRowBytes + 32 * kk, 16, 1024),
            (c | kk) != 0);
    wgmma_commit();
  }

  // O += P V over a tile's kv rows, 16 per wgmma (issued, not waited on)
  __device__ __forceinline__ void issue_pv(int st) {
    const uint8_t* vt = vs + st * kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb)
      wgmma_rs<D>(acc, &p[4 * kb],
                  gmma_desc(vt + 16 * kb * kRowBytes, kBK * kRowBytes, 1024),
                  1);
    wgmma_commit();
  }

  __device__ __forceinline__ void fence_s() {
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) reg_fence(s[j]);
  }
  __device__ __forceinline__ void fence_acc_p() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) reg_fence(acc[j]);
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) reg_fence(p[j]);
  }

  // Online softmax of the tile at kv position k0, in place on S's
  // accumulator (s[4j + 2r + e] is row row0 + 8r, column k0 + 8j + 2 quad
  // + e): S becomes P, (m, l) move on, and corr is the factor by which O
  // must be rescaled.  m is kept in unscaled score units, so each
  // probability is one FFMA and one ex2.  kMask: the tile crosses the
  // diagonal or T, and the sentinel and safe-max guards apply; a tile
  // without it has no masked score, and m is finite after tile 0.
  template <bool kMask>
  __device__ __forceinline__ void softmax(int k0, float* corr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[4 * j + 2 * r + e];
          if (kMask) {
            const int kpos = k0 + 8 * j + 2 * quad + e;
            const bool dead = kpos >= Tk || (causal && kpos > qpos + q_off);
            v = dead ? kNegInf : v;
            s[4 * j + 2 * r + e] = v;
          }
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float safe_m = !kMask || m_new > kNegInf / 2 ? m_new : 0.f;
      const float ms = safe_m * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = s[4 * j + 2 * r + e];
          float pv = ex2(fmaf(v, scale_log2, -ms));
          if (kMask) pv = v > kNegInf / 2 ? pv : 0.f;
          s[4 * j + 2 * r + e] = pv;
          rs += pv;
        }
      corr[r] = ex2((m[r] - safe_m) * scale_log2);
      if (kMask) corr[r] = m[r] > kNegInf / 2 ? corr[r] : 0.f;
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }
  }

  // O *= corr; P to bf16 (the accumulator layout of S's columns 16 kb ..
  // 16 kb + 15 is the A fragment of the kb-th k16 step)
  __device__ __forceinline__ void rescale_and_pack(const float* corr) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[4 * j + 2 * r] *= corr[r];
        acc[4 * j + 2 * r + 1] *= corr[r];
      }
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        p[4 * kb + x] = pack_bf16(s[8 * kb + 2 * x], s[8 * kb + 2 * x + 1]);
  }

  // Tiles begin .. end - 1: S, softmax, O += P V.  The two consumer
  // warpgroups run this loop side by side, so one's softmax overlaps the
  // other's products.
  template <bool kMask>
  __device__ __forceinline__ void steady(int begin, int end) {
    for (int i = begin; i < end; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      mbar_wait(&k_full[st], ph);
      issue_s(st);
      wgmma_wait<0>();
      fence_s();
      release(&k_empty[st]);
      float corr[2];
      softmax<kMask>(i * kBK, corr);
      rescale_and_pack(corr);
      mbar_wait(&v_full[st], ph);
      issue_pv(st);
      wgmma_wait<0>();
      fence_acc_p();
      release(&v_empty[st]);
    }
  }

  // Tiles wholly above the diagonal for these rows (not for the CTA's
  // other warpgroup): nothing to add, the buffers are handed back.
  __device__ __forceinline__ void skip(int begin, int end) {
    for (int i = begin; i < end; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      mbar_wait(&k_full[st], ph);
      release(&k_empty[st]);
      mbar_wait(&v_full[st], ph);
      release(&v_empty[st]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int S, int Tk, int Hq,
                 int Hkv, int causal, int q_off, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int kBK = Sh::kBK;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + Sh::kQBytes;              // [stage][col block][kBK][64]
  uint8_t* vs = ks + kStages * Sh::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * Sh::kKVBytes);
  uint64_t* k_full = q_full + 1;               // [kStages] each
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * kBQ;  // longest rows first
  const int b = blockIdx.x / Hq;
  const int h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  int n_kv = (Tk + kBK - 1) / kBK;
  if (causal) n_kv = min(n_kv, (min(q0 + kBQ, S) - 1 + q_off) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2 * kWG / 32);    // one arrival per warp
      mbar_init(&v_empty[s], 2 * kWG / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;  // 0, 1: consumers; 2: the producer
  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * kWG) {
      mbar_expect_tx(q_full, Sh::kQBytes);
#pragma unroll
      for (int c = 0; c < Sh::kCols; ++c)
        tma_load_4d(qs + c * kBQ * kRowBytes, &qmap, q_full, 64 * c, h, q0,
                    b);
      for (int i = 0; i < n_kv; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        uint8_t* kd = ks + st * Sh::kKVBytes;
        uint8_t* vd = vs + st * Sh::kKVBytes;
        mbar_wait(&k_empty[st], ph ^ 1);       // round 0 passes at once
        mbar_expect_tx(&k_full[st], Sh::kKVBytes);
#pragma unroll
        for (int c = 0; c < Sh::kCols; ++c)
          tma_load_4d(kd + c * kBK * kRowBytes, &kmap, &k_full[st], 64 * c,
                      hk, i * kBK, b);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], Sh::kKVBytes);
#pragma unroll
        for (int c = 0; c < Sh::kCols; ++c)
          tma_load_4d(vd + c * kBK * kRowBytes, &vmap, &v_full[st], 64 * c,
                      hk, i * kBK, b);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % kWG;
    Consumer<D> cs;
    cs.first = q0 + 64 * wg;
    cs.qw = qs + 64 * wg * kRowBytes;
    cs.ks = ks;
    cs.vs = vs;
    cs.k_full = k_full;
    cs.v_full = v_full;
    cs.k_empty = k_empty;
    cs.v_empty = v_empty;
    cs.row0 = cs.first + 16 * (t / 32) + (t % 32) / 4;
    cs.quad = t % 4;
    cs.Tk = Tk;
    cs.causal = causal;
    cs.q_off = q_off;
    cs.scale_log2 = scale_log2;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) cs.acc[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cs.m[r] = kNegInf;
      cs.l[r] = 0.f;
    }

    // Tiles [0, n_live) hold positions these rows see; of them, those from
    // n_plain on cross the diagonal (causal) or T and are masked.  The
    // diagonal of these rows starts at key position first + q_off.
    const int diag = cs.first + q_off;
    const int n_live =
        causal ? min(n_kv, (diag + 63) / kBK + 1) : n_kv;
    const int n_plain =
        max(1, min(n_live, causal ? min((diag + 1) / kBK, Tk / kBK)
                                  : Tk / kBK));
    mbar_wait(q_full, 0);
    cs.template steady<true>(0, 1);
    cs.template steady<false>(1, n_plain);
    cs.template steady<true>(n_plain, n_live);
    cs.skip(n_live, n_kv);

    // out = acc / l, rows past S never stored
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = cs.l[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int s_pos = cs.row0 + 8 * r;
      if (s_pos >= S) continue;
      const float inv = 1.f / fmaxf(l, 1e-30f);
      __nv_bfloat16* orow =
          o + (((long long)b * S + s_pos) * Hq + h) * D + 2 * cs.quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(cs.acc[4 * j + 2 * r] * inv,
                                  cs.acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, H, L, B) bf16 tensor map over x (B, L, H, D), boxes of 64 columns
// x ``rows`` positions of one head, 128-byte swizzle, zeros outside.
bool make_map(CUtensorMap* map, const void* x, int D, int H, int L, int B,
              int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S, int Tk,
             int Hq, int Hkv, int causal, int q_off, float scale,
             cudaStream_t stream) {
  using Sh = Shape<D>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, D, Hq, S, B, kBQ) ||
      !make_map(&km, k, D, Hkv, Tk, B, Sh::kBK) ||
      !make_map(&vm, v, D, Hkv, Tk, B, Sh::kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  attn_sm90_kernel<D><<<grid, kThreads, Sh::kSmem, stream>>>(
      qm, km, vm, o, S, Tk, Hq, Hkv, causal, q_off, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_sm90_bf16(const __nv_bfloat16* q,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         __nv_bfloat16* o, int B, int S,
                                         int Tk, int Hq, int Hkv, int D,
                                         int causal, int q_off,
                                         float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, q_off,
                          scale, stream);
    case 128:
      return launch_d<128>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, q_off,
                           scale, stream);
    case 256:
      return launch_d<256>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, q_off,
                           scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
