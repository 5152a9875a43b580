// Hopper (sm_90a) warpgroup-MMA kernels for the dense U-Net's 3x3x3
// convolutions: SAME, stride 2, and the stride-2 transpose.
//
// Replaces three Pallas TPU kernels of syconn_tpu/ops/conv3d_pallas.py:
//   * conv3x3x3_ln_gelu      (:70)  SAME 3x3x3 conv + bf16 bias, then nothing
//                                    ("bias") or LayerNorm + tanh-GELU, with an
//                                    optional fused f32 1x1x1 head;
//   * conv_down2x_bias       (:393) stride-2 SAME conv + bias (XLA SAME for even
//                                    extents: pad low 0, high 1);
//   * conv_transpose2x_bias  (:261) flax ConvTranspose (SAME, k3, s2) + bias as
//                                    8 sub-pixel output phases.
// (Only the fallback named below stays in conv3d.cu.) And nnU-Net's forms,
// which no Pallas kernel has: the stride-2 conv padded (1, 1) (mode 3: the
// stride-2 conv's halo units shifted down one voxel, TMA's zero fill the low
// pad), the kernel-2 stride-2 transpose (mode 4: the transpose's machinery
// with one tap a phase and no halo), and a Cout of 320 (bias epilogue only:
// wgmma's N stops at 256, so two blocks take 160 channels each of a brick,
// their weight images packed one after the other).
//
// Bound on the H100: at the main-path widths the convs do ~27*Cout/2 FLOP per
// input byte, far above the ~295 FLOP/byte ridge, so tensor-core operations
// bound them; the transpose at 40^3 128->64 has bytes and operations about
// level. What held the first kernels (conv3d.cu) at 10-15% of the tensor-core
// peak was not operations but a block-wide barrier per tap, mma.sync, and
// 64-row blocks that each re-read every weight from L2.
//
// Design.
//   * Implicit GEMM on wgmma.mma_async m64nNk16, N = Cout (32..256), f32
//     accumulators in registers, both operands from shared memory by
//     descriptor. A block of 384 threads is one producer warpgroup and two
//     consumer warpgroups (setmaxnreg 40 / 232). It owns a brick of
//     BX x 8 x 8 output rows times ALL Cout (LayerNorm needs a row's channels
//     together), BX = 2 * MT, each consumer warpgroup MT tiles of 64 rows (one
//     x, 8 y, 8 z): 128 rows at Cout 256, 256 at Cout 128, 512 at Cout 64 and
//     32 (128 accumulator registers a thread). Weights are so re-read from L2
//     2-8 times less often than with 64-row blocks, and an 8x8x8 brick loads
//     1.95 halo voxels per row instead of 3.4.
//   * A comes from shared memory by descriptor, not from registers: the halo
//     of a 32-channel slice is stored as [8-channel group][x][y][z][16 bytes]
//     (no swizzle; a core matrix is 8 consecutive z, 128 contiguous bytes), so
//     a tap is a shift of the descriptor's start address, LBO the stride
//     between channel groups and SBO the halo's z-row pitch. The consumers do
//     no per-lane address arithmetic and hold no A fragments, which leaves the
//     registers to the accumulators; the price is the fixed 8 x 8 tile (20^3
//     pads to 24 x 24 rows per x). A loop of nothing but these wgmmas at these
//     layouts, addresses changing every step, runs at the tensor cores' full
//     rate on the card (32 clocks per m64n64k16 and SM), so neither the
//     missing swizzle nor the tap-shifted start addresses cost anything.
//   * Descriptors are built once per slice and stage; a tap, a tile or a k16
//     step only adds a constant to the start-address field. The warpgroup
//     index is shuffled from lane 0 so that the compiler keeps all of this in
//     uniform registers instead of re-encoding every descriptor from
//     per-thread values between the wgmmas.
//   * B: the wrapper repacks the (27, Cin, Cout) weights once per tensor into
//     K-major stage images [tap][slice][k group][Cout][8] (Cin zero-padded to
//     32), so one cp.async.bulk (the TMA's linear form, no tensor map) lands
//     a whole (32 x Cout) stage and signals its mbarrier with the byte count.
//   * A ring of up to 16 weight stages (what shared memory leaves) and a
//     double-buffered halo, each buffer with a full and an empty mbarrier.
//     Producer warp 0 streams the weights, warps 1-3 copy the halo with
//     16-byte cp.async (zero fill gives the SAME padding, the ragged edge and
//     the channel padding), then fence.proxy.async and arrive. The consumers
//     wait on two stages, start the wgmmas of two taps, commit, keep one
//     group in flight and release what the group before it read. The main
//     loop has no __syncthreads; the only block-wide barrier follows the
//     mbarrier init.
//   * Persistent blocks, one per SM, walk over the bricks; the rings run on
//     across bricks, so the next brick's first halo slices and weight stages
//     arrive during this brick's epilogue.
//   * Epilogue from the accumulator registers: a row lives in the four lanes
//     of a quad, so bf16 rounding, the bf16 bias add, LayerNorm (two shuffles)
//     and GELU need no f32 staging. The bf16 result goes through a per-warp
//     shared-memory stage (conflict-free pitch) and leaves in 16-byte stores,
//     whole rows of Cout contiguous. GELU's tanh is 1 - 2 / (1 + exp(2u)) with
//     __expf and __fdividef (about 1e-6 relative), not tanh.approx (2^-11).
//   * The head runs on the tensor cores: the bf16 activation is repacked in
//     registers into wgmma A fragments (the accumulator layout of an n8 pair
//     is the A layout of a k16 step), the f32 head weight is split by the
//     wrapper into three bf16 parts (hi + mid + lo carry 24 mantissa bits) that
//     stay in shared memory for the block's life, and three bf16 products with
//     f32 accumulation give an f32 product to f32's own rounding, 32 logits at
//     a time. The logits go through the warp's stage too, so that a store
//     instruction writes four whole 128-byte lines: straight from the
//     accumulators (8 rows x 32 bytes an instruction) the stores of 197 MB of
//     logits took twice as long as the bytes need.
//   * The transpose computes all eight phases of its brick in one block: the
//     phases are an outer loop over the same machinery (27 taps in all, every
//     block the same work; the accumulators of eight phases would not fit the
//     registers). Its bricks are half as long, so that every slice of the
//     halo stays in shared memory (up to 16 buffers): loaded once per brick,
//     read by all eight phases. Where Cin is too large for that, the slices
//     stream through two buffers once per phase (slower: a phase with one tap
//     per slice then waits for the copies).
//   * The stride-2 conv reads x[2r + d]: at stride 2 the rows of a core
//     matrix would sit 32 bytes apart, which no descriptor expresses. So its
//     halo is cut by input phase: the unit of phase (px, py, pz) holds
//     x[2h + p] for a (BX + 1) x 9 x 9 halo h in the same [group][x][y][z][16 B]
//     layout, and tap d reads it at h = r + d / 2 (phase bit d % 2): 8 units a
//     32-channel slice with 8, 4, 4, 2, 4, 2, 2 and 1 taps, all into one set
//     of accumulators. (The whole (2BX + 1) x 17 x 17 halo of a slice, split
//     only by z parity, takes 98 KB at BX = 2 and leaves no room for a second
//     buffer beside the stages.) A unit arrives as four TMA boxes (one per
//     channel group) of a tensor map with traversal stride 2, issued by one
//     producer thread: a unit serves only ~3.4 taps, and with 96 threads
//     computing cp.async addresses the consumers waited on the halo half the
//     time. TMA's zero fill is the high pad and the channel padding; nothing
//     is copied in device memory beforehand. Four units stream through the
//     halo ring.
//   * -DCONV3D_TIMING keeps clock counts of block 0's waits, wgmma starts and
//     epilogues (syconn_tpu_torch/tools/conv3d_breakdown.py builds with it and
//     reads them). They go to a device array, never through printf: a printf
//     anywhere in the kernel makes ptxas serialise the wgmmas.
//
// What the new kernel does not take: a head whose three bf16 parts do not fit
// shared memory beside the halo and two stages (3 * Cout * roundup(Nh, 32) * 2
// bytes; e.g. Cout 256 with Nh 96). conv3d_wgmma_plan() then returns 0 and the wrapper
// sends that shape to the mma.sync kernel of conv3d.cu (MODE_SAME). Every
// shape of the dense-prediction main path takes the kernel of this file.
//
// Epilogue op order follows the Pallas kernel exactly (conv3d_pallas.py:196-214):
//   round f32 acc to bf16 -> add bf16 bias in bf16 -> [LayerNorm in f32,
//   var = E[x^2] - mu^2, eps 1e-6 -> tanh-GELU in f32 -> cast bf16]
//   -> [head: f32 matmul on the bf16-rounded activation + f32 bias].
//
// Plain C interface (loaded with ctypes by syconn_tpu_torch/ops/build.py).

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#ifdef CONV3D_TIMING
__device__ long long g_dbg[64];
#define TICK(v) long long v = clock64()
#define TOCK(acc_, v) acc_ += clock64() - v
#else
#define TICK(v)
#define TOCK(acc_, v)
#endif

namespace {

constexpr int KC = 32;            // input channels per halo slice and weight stage
constexpr int TY = 8, TZ = 8;     // a 64-row tile: one x, 8 y, 8 z
constexpr int NPROD = 128;        // producer warpgroup
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NTHREADS = NPROD + NCONS;
constexpr int NHALO_THREADS = 96; // producer warps 1-3
constexpr int HEAD_CHUNK = 32;    // logits per head wgmma
constexpr int MAX_STAGES = 16;     // weight ring
constexpr int MAX_HALO_BUFS = 16;  // halo slices held at once
constexpr int TAP_OFFSET = 8 * (2 * MAX_STAGES + 2 * MAX_HALO_BUFS + 1);  // behind the mbarriers
constexpr int BAR_BYTES = TAP_OFFSET + 120;  // 640: mbarriers, then the block's 27 taps
constexpr int SMEM_LIMIT = 232448;

enum Mode { MODE_SAME = 0, MODE_DOWN = 1, MODE_UP = 2, MODE_DOWN_PAD = 3, MODE_UP2 = 4 };
// the stride-2 convs (one reads x[2o + d], the other x[2o + d - 1]) and the
// stride-2 transposes (k3 and k2) share their machinery
__host__ __device__ constexpr bool is_down(int mode) {
  return mode == MODE_DOWN || mode == MODE_DOWN_PAD;
}
__host__ __device__ constexpr bool is_up(int mode) { return mode == MODE_UP || mode == MODE_UP2; }
enum Epi { EPI_BIAS = 0, EPI_LN_GELU = 1 };

struct Args {
  CUtensorMap tmap;           // stride 2: x as (cin, Z, Y, X, B), every second voxel
  const __nv_bfloat16* x;     // (B, X, Y, Z, cin)
  const __nv_bfloat16* wp;    // packed weights (27, nk, 4, cout, 8)
  const __nv_bfloat16* bias;  // (cout)
  const float* ln_g;          // (cout) or null
  const float* ln_b;          // (cout) or null
  const __nv_bfloat16* hp;    // packed head (3, cout / 8, nhp, 8) or null
  const float* head_b;        // (nh) or null
  void* out;                  // bf16 (B, OX, OY, OZ, cout) or f32 (..., nh)
  int B, X, Y, Z;             // row space: the input's extents (SAME, transpose) or the
                              // output's (stride 2: the input is twice as large)
  int cin, cout, nh, nhp, epi;
  int nbx, nby, nbz, nbricks; // bricks per axis, and in all
  int nst;                    // weight stages in the ring
  int nhb;                    // halo buffers: 2 (slices stream), or all slices resident
};

// ----------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spin until the barrier's phase of the given parity has completed. A wait
// that lasts seconds is a lost arrive: trap instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0, spins = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (++spins == 4096) t0 = clock64();
    if (spins > 4096 && (spins & 1023) == 0 && clock64() - t0 > 4000000000LL) __trap();
  }
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// TMA: a box of the tensor map at coordinates (c, z, y, x, b) into shared
// memory, completing `bytes` on the mbarrier; out-of-range elements are zeros
__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, int c, int z, int y,
                                       int x, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(z), "r"(y), "r"(x), "r"(b), "r"(bar)
      : "memory");
}
// 16-byte cp.async; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: a core matrix is 8
// rows of 16 bytes (8 bf16 along K) at a 16-byte row pitch; `lbo` is the byte
// stride between core matrices along K, `sbo` along M/N (8 rows further).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x N, f32) += A (64 x 16, bf16) * B (16 x N, bf16); A and B K-major in
// shared memory (wgmma_ss) or A as this warp's fragment registers (wgmma_rs).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
      "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ geometry
// Halo of a brick of BX x 8 x 8 rows. SAME reads x[r + d - 1], d in 0..2; the
// transpose reads x[u - 1] (tap 0 of an even output phase) or x[u] (taps 1, 2);
// the k2 transpose reads x[u] alone (no halo).
// The stride-2 conv reads x[2r + d] (x[2r + d - 1] padded low by 1): its halo
// is one of the eight input phases x[2h + p] (p = d % 2; shifted by one voxel
// when padded low), which tap d reads at h = r + d / 2, so that consecutive
// rows stay 16 bytes apart; one halo unit per phase and slice.
template <int MODE, int BX>
struct Geo {
  static constexpr int E = MODE == MODE_SAME ? 2 : MODE == MODE_UP2 ? 0 : 1;
  static constexpr int HX = BX + E, HY = TY + E, HZ = TZ + E;
  static constexpr int HP = HX * HY * HZ;
  // channel-group plane stride in 16-byte units, 2 mod 8: the four planes a
  // loader quad writes fall on different banks
  // (the stride-2 conv's units arrive by TMA, which wants 128-byte aligned planes)
  static constexpr int PS = is_down(MODE) ? (HP + 7) / 8 * 8 : HP + (10 - HP % 8) % 8;
  static constexpr int HALO_BYTES = 4 * PS * 16;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Layout {
  int par, halo, w, stage_bytes, out, out_bytes, head, total;
};
// Shared-memory map of one block; mirrored by tile_plan() in ops/conv3d.py.
__host__ __device__ constexpr Layout make_layout(int halo_bytes, int nhb, int cout, int nst,
                                                 int nhp) {
  Layout l{};
  l.par = BAR_BYTES;  // after the mbarriers
  l.halo = l.par + round_up(cout * 10, 128);
  l.w = l.halo + nhb * halo_bytes;
  l.stage_bytes = KC * cout * 2;
  l.out = l.w + nst * l.stage_bytes;
  // per consumer warp: 16 output rows, bf16 (cout + 8 a row) or f32 logits (32 + 4 a row)
  const int rows_bf16 = 16 * (cout * 2 + 16), rows_f32 = 16 * (HEAD_CHUNK + 4) * 4;
  l.out_bytes = nhp > 0 && rows_f32 > rows_bf16 ? rows_f32 : rows_bf16;
  l.head = l.out + (NCONS / 32) * l.out_bytes;
  l.total = l.head + 3 * cout * nhp * 2;
  return l;
}

__device__ __forceinline__ int phase_taps(int phase) {
  return (((phase >> 2) & 1) ? 1 : 2) * (((phase >> 1) & 1) ? 1 : 2) * ((phase & 1) ? 1 : 2);
}
// First entry of a phase in the tap list: 0, 8, 12, 16, 18, 22, 24, 26.
__device__ __forceinline__ int phase_tap0(int phase) {
  return (int)((0x1A181612100C0800ull >> (8 * phase)) & 0xFFu);
}

// The k2 transpose: one tap a phase, the phase's own 2x2x2 kernel entry.
template <int MODE>
__device__ __forceinline__ int phase_ntaps(int phase) {
  return MODE == MODE_UP2 ? 1 : phase_taps(phase);
}
template <int MODE>
__device__ __forceinline__ int phase_first(int phase) {
  return MODE == MODE_UP2 ? phase : phase_tap0(phase);
}

// Entry i of the block's tap list (the eight phases of the transpose or of the
// stride-2 conv's input one after the other, 27 entries in every mode but the
// k2 transpose's 8) -> flat weight tap t and halo offset in 16-byte units. A
// phase bit p of an axis takes tap d = 1 (p = 1) or d in {0, 2} (p = 0); the
// transpose reads it at offset d > 0, the stride-2 conv at d / 2. The k2
// transpose's phase i reads weight tap i at offset 0.
template <int MODE, int HY, int HZ>
__device__ __forceinline__ void tap_entry(int i, int& t, int& delta) {
  int dx, dy, dz, ox, oy, oz;
  if (MODE == MODE_UP2) {
    t = i;
    delta = 0;
    return;
  }
  if (MODE != MODE_SAME) {
    int phase = 0, ti = i;
    while (ti >= phase_taps(phase)) ti -= phase_taps(phase++);
    const int px = (phase >> 2) & 1, py = (phase >> 1) & 1, pz = phase & 1;
    const int ny = py ? 1 : 2, nz = pz ? 1 : 2;
    const int iz = ti % nz, iy = (ti / nz) % ny, ix = ti / (nz * ny);
    dx = px ? 1 : (ix ? 2 : 0);
    dy = py ? 1 : (iy ? 2 : 0);
    dz = pz ? 1 : (iz ? 2 : 0);
    if (MODE == MODE_UP) {
      ox = dx ? 1 : 0; oy = dy ? 1 : 0; oz = dz ? 1 : 0;
    } else {
      ox = dx >> 1; oy = dy >> 1; oz = dz >> 1;
    }
  } else {
    dx = i / 9; dy = (i / 3) % 3; dz = i % 3;
    ox = dx; oy = dy; oz = dz;
  }
  t = dx * 9 + dy * 3 + dz;
  delta = (ox * HY + oy) * HZ + oz;
}

__device__ __forceinline__ float gelu_tanh(float y) {
  // jax.nn.gelu(approximate=True): 0.5 y (1 + tanh u) = y / (1 + exp(-2u))
  const float u = 0.7978845608028654f * (y + 0.044715f * (y * y * y));
  return y * __fdividef(1.0f, 1.0f + __expf(-2.0f * u));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A position in a ring of n buffers with its mbarrier parity.
struct Ring {
  int i;
  uint32_t par;
  __device__ __forceinline__ void next(int n) {
    if (++i == n) { i = 0; par ^= 1u; }
  }
};

// ------------------------------------------------------------ the kernel
// Persistent: block k walks over bricks k, k + gridDim.x, ...; the rings run
// on across bricks, so the producers load the next brick's first halo slices
// and weight stages while the consumers are in the epilogue of this one.
// NSPL > 1: the output channels split over NSPL blocks, COUT each (bias
// epilogue only); block k computes part k % NSPL of the bricks k / NSPL,
// k / NSPL + gridDim.x / NSPL, ...
template <int MODE, int COUT, int MT, int NSPL = 1>
__global__ void __launch_bounds__(NTHREADS, 1) conv3d_wgmma_kernel(const __grid_constant__ Args a) {
  constexpr int BX = 2 * MT;
  using G = Geo<MODE, BX>;
  constexpr int HY = G::HY, HZ = G::HZ, HP = G::HP, PS = G::PS;
  constexpr int NACC = COUT / 2;
  constexpr int NEPI = is_up(MODE) ? 8 : 1;     // epilogues (output phases) per brick
  constexpr int NIN = is_down(MODE) ? 8 : 1;    // halo units (input phases) per slice
  constexpr int NTAPS = MODE == MODE_UP2 ? 8 : 27;  // weight taps
  constexpr int LO = MODE == MODE_UP2 ? 0 : 1;  // halo rows below the brick
  constexpr int PLO = MODE == MODE_DOWN_PAD ? 1 : 0;  // the stride-2 conv's low pad
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(G::HALO_BYTES, a.nhb, COUT, a.nst, a.nhp);
  const int nst = a.nst;
  // all slices of the brick stay in shared memory (transpose): loaded once per
  // brick, used by all eight phases; the k2 transpose always keeps them
  const bool resident = MODE == MODE_UP2 || (MODE == MODE_UP && a.nhb > 2);
  // this block's part of the output channels, and the bricks it walks
  const int part = NSPL > 1 ? (int)(blockIdx.x % NSPL) : 0;
  const int brick0 = NSPL > 1 ? (int)(blockIdx.x / NSPL) : (int)blockIdx.x;
  const int bstep = NSPL > 1 ? (int)(gridDim.x / NSPL) : (int)gridDim.x;
  const __nv_bfloat16* wp = NSPL > 1 ? a.wp + (size_t)part * NTAPS * ((a.cin + KC - 1) / KC) * KC * COUT
                                     : a.wp;

  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_wfull = sbase, bar_wempty = sbase + 8 * MAX_STAGES;
  const uint32_t bar_hfull = sbase + 16 * MAX_STAGES;
  const uint32_t bar_hempty = bar_hfull + 8 * MAX_HALO_BUFS;
  const uint32_t bar_head = bar_hempty + 8 * MAX_HALO_BUFS;
  uint32_t* s_tap = reinterpret_cast<uint32_t*>(smem + TAP_OFFSET);  // (t << 16) | delta
  __nv_bfloat16* s_bias = reinterpret_cast<__nv_bfloat16*>(smem + L.par);
  float* s_g = reinterpret_cast<float*>(smem + L.par + COUT * 2);
  float* s_b = s_g + COUT;

  const int tid = threadIdx.x;
  const int nk = (a.cin + KC - 1) / KC;

  for (int c = tid; c < COUT; c += NTHREADS) {
    s_bias[c] = a.bias[part * COUT + c];
    if (MODE == MODE_SAME && NSPL == 1 && a.epi == EPI_LN_GELU) {
      s_g[c] = a.ln_g[c];
      s_b[c] = a.ln_b[c];
    }
  }
  if (tid < 27) {
    int t, delta;
    tap_entry<MODE, HY, HZ>(tid, t, delta);
    s_tap[tid] = ((uint32_t)t << 16) | (uint32_t)delta;
  }
  if (tid == 0) {
    for (int i = 0; i < nst; ++i) {
      mbar_init(bar_wfull + 8 * i, 1);
      mbar_init(bar_wempty + 8 * i, NCONS / 32);
    }
    for (int i = 0; i < a.nhb; ++i) {
      mbar_init(bar_hfull + 8 * i, is_down(MODE) ? 1 : NHALO_THREADS);
      mbar_init(bar_hempty + 8 * i, NCONS / 32);
    }
    mbar_init(bar_head, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < NPROD) {
    // ===================================================== producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      if (a.nhp > 0) {
        const uint32_t bytes = 3u * COUT * a.nhp * 2u;
        mbar_expect_tx(bar_head, bytes);
        bulk_g2s(sbase + L.head, a.hp, bytes, bar_head);
      }
      Ring r{0, 1u};  // a fresh barrier passes a wait on parity 1: the ring starts empty
#ifdef CONV3D_TIMING
      long long p_wait = 0;
      TICK(p_all);
#endif
      for (int brick = brick0; brick < a.nbricks; brick += bstep) {
        for (int po = 0; po < NEPI; ++po) {
          for (int kc = 0; kc < nk; ++kc) {
            for (int pi = 0; pi < NIN; ++pi) {
              const int phase = is_up(MODE) ? po : pi;
              const int tap0 = MODE == MODE_SAME ? 0 : phase_first<MODE>(phase);
              const int ntap = MODE == MODE_SAME ? 27 : phase_ntaps<MODE>(phase);
              for (int ti = 0; ti < ntap; ++ti) {
                TICK(p0);
                mbar_wait(bar_wempty + 8 * r.i, r.par);
                TOCK(p_wait, p0);
                const int t = s_tap[tap0 + ti] >> 16;
                mbar_expect_tx(bar_wfull + 8 * r.i, L.stage_bytes);
                bulk_g2s(sbase + L.w + r.i * L.stage_bytes,
                         wp + ((size_t)t * nk + kc) * (KC * COUT), L.stage_bytes,
                         bar_wfull + 8 * r.i);
                r.next(nst);
              }
            }
          }
        }
      }
#ifdef CONV3D_TIMING
      if (blockIdx.x == 0) { g_dbg[20] = clock64() - p_all; g_dbg[21] = p_wait; }
#endif
    } else if (is_down(MODE) && tid == 32) {
      // The stride-2 conv: one unit = one input phase (px, py, pz) of a
      // 32-channel slice, x[2h + p - PLO] for h in a (BX + 1) x 9 x 9 halo, as
      // four TMA boxes (one per 8-channel group) of every second voxel. A unit
      // that reaches past either end of the input gets zeros there: the pads,
      // and the channel padding past Cin. No thread computes an address.
      constexpr uint32_t BOX = (BX + 1) * 81 * 16;
      Ring r{0, 1u};
      for (int brick = brick0; brick < a.nbricks; brick += bstep) {
        int blk = brick;
        const int bz = blk % a.nbz; blk /= a.nbz;
        const int by = blk % a.nby; blk /= a.nby;
        const int bx = blk % a.nbx; blk /= a.nbx;
        for (int kc = 0; kc < nk; ++kc) {
          for (int pi = 0; pi < NIN; ++pi) {
            mbar_wait(bar_hempty + 8 * r.i, r.par);
            const uint32_t bar = bar_hfull + 8 * r.i;
            const uint32_t dst = sbase + L.halo + r.i * G::HALO_BYTES;
            mbar_expect_tx(bar, 4 * BOX);
            const int x0 = 2 * bx * BX + ((pi >> 2) & 1) - PLO;
            const int y0 = 2 * by * TY + ((pi >> 1) & 1) - PLO;
            const int z0 = 2 * bz * TZ + (pi & 1) - PLO;
#pragma unroll
            for (int v = 0; v < 4; ++v)
              tma_5d(dst + v * PS * 16, &a.tmap, kc * KC + v * 8, z0, y0, x0, blk, bar);
            r.next(a.nhb);
          }
        }
      }
    } else if (!is_down(MODE) && tid >= 32) {
      const int ht = tid - 32;
      Ring r{0, 1u};
      for (int brick = brick0; brick < a.nbricks; brick += bstep) {
        int blk = brick;
        const int bz = blk % a.nbz; blk /= a.nbz;
        const int by = blk % a.nby; blk /= a.nby;
        const int bx = blk % a.nbx; blk /= a.nbx;
        const __nv_bfloat16* xb = a.x + (size_t)blk * a.X * a.Y * a.Z * a.cin;
        const int hx0 = bx * BX - LO, hy0 = by * TY - LO, hz0 = bz * TZ - LO;
        for (int phase = 0; phase < (resident ? 1 : NEPI); ++phase) {
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(bar_hempty + 8 * r.i, r.par);
            const uint32_t dst0 = sbase + L.halo + r.i * G::HALO_BYTES;
            for (int i = ht; i < HP * 4; i += NHALO_THREADS) {
              const int p = i >> 2, v = i & 3;
              const int hz = p % HZ, hy = (p / HZ) % HY, hx = p / (HZ * HY);
              const int gx = hx0 + hx, gy = hy0 + hy, gz = hz0 + hz;
              const int c = kc * KC + v * 8;
              const bool ok = gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 &&
                              gz < a.Z && c < a.cin;
              const __nv_bfloat16* src =
                  ok ? xb + (((size_t)gx * a.Y + gy) * a.Z + gz) * a.cin + c : a.x;
              cp_async16(dst0 + (v * PS + p) * 16, src, ok ? 16 : 0);
            }
            cp_async_wait_all();
            fence_proxy_async();
            mbar_arrive(bar_hfull + 8 * r.i);
            r.next(a.nhb);
          }
        }
      }
    }
  } else {
    // ===================================================== consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ctid = tid - NPROD;
    // shuffled from lane 0, so that the compiler knows the value is the same in
    // the whole warp and builds the wgmma descriptors in uniform registers
    const int wg = __shfl_sync(0xffffffffu, ctid >> 7, 0);
    const int w4 = (ctid >> 5) & 3, cwarp = ctid >> 5, lane = ctid & 31;
    const int g = lane >> 2, tq = lane & 3;
    constexpr int SROW = COUT * 2 + 16;  // staging row pitch (bytes)
    unsigned char* stage_out = smem + L.out + cwarp * L.out_bytes;
    const bool ln = MODE == MODE_SAME && NSPL == 1 && a.epi == EPI_LN_GELU;
    const bool head = MODE == MODE_SAME && NSPL == 1 && a.nhp > 0;
    const int up = is_up(MODE) ? 2 : 1;
    const int OY = up * a.Y, OZ = up * a.Z;

    float acc[MT][NACC];
    Ring rw{0, 0u}, rh{0, 0u};
    int rel_stage = -1, rel_stage2 = -1, rel_halo = -1;
    bool head_ready = false;
#ifdef CONV3D_TIMING
    long long t_halo = 0, t_w = 0, t_mma = 0, t_epi = 0, t_wait1 = 0;
    TICK(t_all);
#endif

    for (int brick = brick0; brick < a.nbricks; brick += bstep) {
      int blk = brick;
      const int bz = blk % a.nbz; blk /= a.nbz;
      const int by = blk % a.nby; blk /= a.nby;
      const int bx = blk % a.nbx; blk /= a.nbx;
      const int b = blk;
      const int r0x = bx * BX, r0y = by * TY, r0z = bz * TZ;

      for (int po = 0; po < NEPI; ++po) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < NACC; ++i) acc[m][i] = 0.f;

        for (int kc = 0; kc < nk; ++kc) {
          for (int pi = 0; pi < NIN; ++pi) {
            const int phase = is_up(MODE) ? po : pi;
            const int tap0 = MODE == MODE_SAME ? 0 : phase_first<MODE>(phase);
            const int ntap = MODE == MODE_SAME ? 27 : phase_ntaps<MODE>(phase);
            // a resident slice is waited for in the first phase and kept until the last
            TICK(q0);
            if (!resident || po == 0) mbar_wait(bar_hfull + 8 * rh.i, rh.par);
            TOCK(t_halo, q0);
            // descriptors of this slice's first slab and of the stage; a tap, a slab
            // or a k16 step only adds to the start-address field (16-byte units)
            const uint64_t da0 = smem_desc(
                sbase + L.halo + rh.i * G::HALO_BYTES + (wg * MT) * (HY * HZ * 16), PS * 16, HZ * 16);
            // two taps a step where the list allows: twice the products per fence,
            // wait and release
            for (int ti = 0; ti < ntap; ti += 2) {
              const bool two = ti + 1 < ntap;
              const uint32_t taps = __shfl_sync(
                  0xffffffffu,
                  (s_tap[tap0 + ti] & 0xffffu) | (two ? s_tap[tap0 + ti + 1] << 16 : 0u), 0);
              const uint64_t da1 = da0 + (taps & 0xffffu), da2 = da0 + (taps >> 16);
              TICK(q1);
              const int st1 = rw.i;
              mbar_wait(bar_wfull + 8 * rw.i, rw.par);
              rw.next(nst);
              const int st2 = two ? rw.i : -1;
              if (two) {
                mbar_wait(bar_wfull + 8 * rw.i, rw.par);
                rw.next(nst);
              }
              TOCK(t_w, q1);
              TICK(q2);
              const uint64_t db1 = smem_desc(sbase + L.w + st1 * L.stage_bytes, COUT * 16, 128);
              const uint64_t db2 =
                  smem_desc(sbase + L.w + (two ? st2 : st1) * L.stage_bytes, COUT * 16, 128);
              wgmma_fence();
#pragma unroll
              for (int m = 0; m < MT; ++m) {
#pragma unroll
                for (int ks = 0; ks < KC / 16; ++ks)
                  wgmma_ss(acc[m], da1 + (m * HY * HZ + ks * 2 * PS), db1 + ks * 2 * COUT);
              }
              if (two) {
#pragma unroll
                for (int m = 0; m < MT; ++m) {
#pragma unroll
                  for (int ks = 0; ks < KC / 16; ++ks)
                    wgmma_ss(acc[m], da2 + (m * HY * HZ + ks * 2 * PS), db2 + ks * 2 * COUT);
                }
              }
              wgmma_commit();
              TOCK(t_mma, q2);
              TICK(q3);
              wgmma_wait<1>();  // the previous step's products are done: release what it read
              TOCK(t_wait1, q3);
              if (lane == 0) {
                if (rel_stage >= 0) mbar_arrive(bar_wempty + 8 * rel_stage);
                if (rel_stage2 >= 0) mbar_arrive(bar_wempty + 8 * rel_stage2);
                if (rel_halo >= 0) mbar_arrive(bar_hempty + 8 * rel_halo);
              }
              rel_stage = st1;
              rel_stage2 = st2;
              rel_halo = (ti + 2 >= ntap && (!resident || po == NEPI - 1)) ? rh.i : -1;
            }
            if (resident && po < NEPI - 1) {
              if (++rh.i == a.nhb) rh.i = 0;  // same buffers, same parity, next phase
            } else {
              rh.next(a.nhb);
            }
          }
        }
        wgmma_wait<0>();
        if (lane == 0) {
          if (rel_stage >= 0) mbar_arrive(bar_wempty + 8 * rel_stage);
          if (rel_stage2 >= 0) mbar_arrive(bar_wempty + 8 * rel_stage2);
          if (rel_halo >= 0) mbar_arrive(bar_hempty + 8 * rel_halo);
        }
        rel_stage = rel_stage2 = rel_halo = -1;

        // ------------------------------------------------- epilogue
        TICK(q4);
        const int px = (po >> 2) & 1, py = (po >> 1) & 1, pz = po & 1;
        if (head && !head_ready) {
          mbar_wait(bar_head, 0);
          head_ready = true;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int qx = r0x + wg * MT + m;
          // this thread's rows: (ry, rz) = (2 w4, g) and (2 w4 + 1, g)
          const int qy0 = r0y + 2 * w4, qz = r0z + g;
          // round to bf16, add the bf16 bias in bf16 (two channels per instruction)
          float s1a = 0.f, s2a = 0.f, s1b = 0.f, s2b = 0.f;
#pragma unroll
          for (int n = 0; n < COUT / 8; ++n) {
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(s_bias + n * 8 + tq * 2);
            const float2 ha = __bfloat1622float2(
                __hadd2(__floats2bfloat162_rn(acc[m][n * 4 + 0], acc[m][n * 4 + 1]), bb));
            const float2 hb = __bfloat1622float2(
                __hadd2(__floats2bfloat162_rn(acc[m][n * 4 + 2], acc[m][n * 4 + 3]), bb));
            acc[m][n * 4 + 0] = ha.x; acc[m][n * 4 + 1] = ha.y;
            acc[m][n * 4 + 2] = hb.x; acc[m][n * 4 + 3] = hb.y;
            s1a += ha.x + ha.y; s2a += ha.x * ha.x + ha.y * ha.y;
            s1b += hb.x + hb.y; s2b += hb.x * hb.x + hb.y * hb.y;
          }
          if (ln) {
#pragma unroll
            for (int sh = 1; sh <= 2; sh <<= 1) {
              s1a += __shfl_xor_sync(0xffffffffu, s1a, sh);
              s2a += __shfl_xor_sync(0xffffffffu, s2a, sh);
              s1b += __shfl_xor_sync(0xffffffffu, s1b, sh);
              s2b += __shfl_xor_sync(0xffffffffu, s2b, sh);
            }
            const float mua = s1a / COUT, mub = s1b / COUT;
            const float rsa = rsqrtf(s2a / COUT - mua * mua + 1e-6f);
            const float rsb = rsqrtf(s2b / COUT - mub * mub + 1e-6f);
#pragma unroll
            for (int n = 0; n < COUT / 8; ++n) {
              const float2 gg = *reinterpret_cast<const float2*>(s_g + n * 8 + tq * 2);
              const float2 be = *reinterpret_cast<const float2*>(s_b + n * 8 + tq * 2);
              acc[m][n * 4 + 0] = gelu_tanh((acc[m][n * 4 + 0] - mua) * rsa * gg.x + be.x);
              acc[m][n * 4 + 1] = gelu_tanh((acc[m][n * 4 + 1] - mua) * rsa * gg.y + be.y);
              acc[m][n * 4 + 2] = gelu_tanh((acc[m][n * 4 + 2] - mub) * rsb * gg.x + be.x);
              acc[m][n * 4 + 3] = gelu_tanh((acc[m][n * 4 + 3] - mub) * rsb * gg.y + be.y);
            }
          }
          if (!head) {
            // bf16 rows through this warp's stage, out in 16-byte stores
            __syncwarp();
#pragma unroll
            for (int n = 0; n < COUT / 8; ++n) {
              *reinterpret_cast<uint32_t*>(stage_out + g * SROW + (n * 8 + tq * 2) * 2) =
                  pack_bf16(acc[m][n * 4 + 0], acc[m][n * 4 + 1]);
              *reinterpret_cast<uint32_t*>(stage_out + (g + 8) * SROW + (n * 8 + tq * 2) * 2) =
                  pack_bf16(acc[m][n * 4 + 2], acc[m][n * 4 + 3]);
            }
            __syncwarp();
            constexpr int CPR = COUT / 8;  // 16-byte chunks per row
            __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out);
#pragma unroll
            for (int it = 0; it < CPR / 2; ++it) {
              const int i = it * 32 + lane;
              const int sr = i / CPR, ch = i % CPR;
              const int ry = qy0 + (sr >> 3), rz = r0z + (sr & 7);
              if (qx < a.X && ry < a.Y && rz < a.Z) {
                const size_t orow =
                    (((size_t)b * (up * a.X) + up * qx + (is_up(MODE) ? px : 0)) * OY +
                     up * ry + (is_up(MODE) ? py : 0)) * OZ + up * rz +
                    (is_up(MODE) ? pz : 0);
                *reinterpret_cast<uint4*>(o + orow * (NSPL * COUT) + part * COUT + ch * 8) =
                    *reinterpret_cast<const uint4*>(stage_out + sr * SROW + ch * 16);
              }
            }
          } else {
            // head: logits = y (bf16, as A fragments) x (hi + mid + lo) + bias, f32
            uint32_t ya[COUT / 16][4];
#pragma unroll
            for (int kk = 0; kk < COUT / 16; ++kk) {
              ya[kk][0] = pack_bf16(acc[m][(2 * kk) * 4 + 0], acc[m][(2 * kk) * 4 + 1]);
              ya[kk][1] = pack_bf16(acc[m][(2 * kk) * 4 + 2], acc[m][(2 * kk) * 4 + 3]);
              ya[kk][2] = pack_bf16(acc[m][(2 * kk + 1) * 4 + 0], acc[m][(2 * kk + 1) * 4 + 1]);
              ya[kk][3] = pack_bf16(acc[m][(2 * kk + 1) * 4 + 2], acc[m][(2 * kk + 1) * 4 + 3]);
            }
            float* o = reinterpret_cast<float*>(a.out);
            const bool oka = qx < a.X && qy0 < a.Y && qz < a.Z;
            const bool okb = qx < a.X && qy0 + 1 < a.Y && qz < a.Z;
            const size_t rowa = (((size_t)b * a.X + qx) * a.Y + qy0) * a.Z + qz;
            const size_t rowb = rowa + a.Z;
            const uint32_t hbase = sbase + L.head;
            const bool quads = (a.nh & 3) == 0;  // 16-byte stores stay aligned
            const bool pairs = (a.nh & 1) == 0;  // 8-byte stores stay aligned
            float* fstage = reinterpret_cast<float*>(stage_out);
            constexpr int FROW = HEAD_CHUNK + 4;  // staged logits row pitch (floats)
            for (int j = 0; j < a.nhp / HEAD_CHUNK; ++j) {
              float hacc[HEAD_CHUNK / 2];
#pragma unroll
              for (int i = 0; i < HEAD_CHUNK / 2; ++i) hacc[i] = 0.f;
              wgmma_fence();
#pragma unroll
              for (int part = 0; part < 3; ++part) {
#pragma unroll
                for (int kk = 0; kk < COUT / 16; ++kk) {
                  const uint64_t db = smem_desc(hbase + part * (COUT * a.nhp * 2) +
                                                    kk * 2 * (a.nhp * 16) + j * HEAD_CHUNK * 16,
                                                a.nhp * 16, 128);
                  wgmma_rs(hacc, ya[kk], db);
                }
              }
              wgmma_commit();
              wgmma_wait<0>();
              if (quads) {
                // through this warp's stage, so that a store instruction writes whole
                // 128-byte lines (4 rows x 32 logits) instead of 8 x 32 bytes
                __syncwarp();
#pragma unroll
                for (int n = 0; n < HEAD_CHUNK / 8; ++n) {
                  *reinterpret_cast<float2*>(fstage + g * FROW + n * 8 + tq * 2) =
                      make_float2(hacc[n * 4 + 0], hacc[n * 4 + 1]);
                  *reinterpret_cast<float2*>(fstage + (g + 8) * FROW + n * 8 + tq * 2) =
                      make_float2(hacc[n * 4 + 2], hacc[n * 4 + 3]);
                }
                __syncwarp();
                const int col = j * HEAD_CHUNK + (lane & 7) * 4;
                if (col < a.nh) {
                  const float4 hb4 = __ldg(reinterpret_cast<const float4*>(a.head_b + col));
#pragma unroll
                  for (int pass = 0; pass < 4; ++pass) {
                    const int sr = pass * 4 + (lane >> 3);
                    const int ry = qy0 + (sr >> 3), rz = r0z + (sr & 7);
                    if (qx < a.X && ry < a.Y && rz < a.Z) {
                      float4 v = *reinterpret_cast<const float4*>(fstage + sr * FROW + (lane & 7) * 4);
                      v.x += hb4.x; v.y += hb4.y; v.z += hb4.z; v.w += hb4.w;
                      const size_t orow = (((size_t)b * a.X + qx) * a.Y + ry) * a.Z + rz;
                      *reinterpret_cast<float4*>(o + orow * a.nh + col) = v;
                    }
                  }
                }
                continue;
              }
#pragma unroll
              for (int n = 0; n < HEAD_CHUNK / 8; ++n) {
                const int col = j * HEAD_CHUNK + n * 8 + tq * 2;
                if (pairs) {
                  if (col < a.nh) {
                    const float2 hb2 = __ldg(reinterpret_cast<const float2*>(a.head_b + col));
                    if (oka)
                      *reinterpret_cast<float2*>(o + rowa * a.nh + col) =
                          make_float2(hacc[n * 4 + 0] + hb2.x, hacc[n * 4 + 1] + hb2.y);
                    if (okb)
                      *reinterpret_cast<float2*>(o + rowb * a.nh + col) =
                          make_float2(hacc[n * 4 + 2] + hb2.x, hacc[n * 4 + 3] + hb2.y);
                  }
                } else {
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    if (col + e < a.nh) {
                      const float hb1 = __ldg(a.head_b + col + e);
                      if (oka) o[rowa * a.nh + col + e] = hacc[n * 4 + e] + hb1;
                      if (okb) o[rowb * a.nh + col + e] = hacc[n * 4 + 2 + e] + hb1;
                    }
                  }
                }
              }
            }
          }
        }
        TOCK(t_epi, q4);
      }
    }
#ifdef CONV3D_TIMING
    if (blockIdx.x == 0 && (ctid == 0 || ctid == 128)) {
      long long* d = g_dbg + wg * 32;
      d[0] = clock64() - t_all; d[1] = t_halo; d[2] = t_w; d[3] = t_mma; d[4] = t_wait1; d[5] = t_epi;
    }
#endif
  }
}

// ------------------------------------------------------------ host side
// Tiles per consumer warpgroup (the brick is 2 * mt x 8 x 8 rows). SAME takes what the accumulators allow; the transpose takes half
// of it, so that all slices of its smaller halo stay resident at the main-path
// widths. `cout` is a block's part of the output channels (160 of a split 320).
inline int tiles_of(int mode, int cout) {
  if (mode == MODE_SAME) return cout >= 160 ? 1 : cout == 128 ? 2 : 4;
  if (is_down(mode)) return cout >= 160 ? 1 : cout == 128 ? 2 : 4;
  return cout >= 128 ? 1 : 2;
}

inline int halo_bytes_of(int mode, int mt) {
  if (mode == MODE_SAME)
    return mt == 1 ? Geo<MODE_SAME, 2>::HALO_BYTES
                   : mt == 2 ? Geo<MODE_SAME, 4>::HALO_BYTES : Geo<MODE_SAME, 8>::HALO_BYTES;
  if (is_down(mode))
    return mt == 1 ? Geo<MODE_DOWN, 2>::HALO_BYTES
                   : mt == 2 ? Geo<MODE_DOWN, 4>::HALO_BYTES : Geo<MODE_DOWN, 8>::HALO_BYTES;
  if (mode == MODE_UP2) return mt == 1 ? Geo<MODE_UP2, 2>::HALO_BYTES : Geo<MODE_UP2, 4>::HALO_BYTES;
  return mt == 1 ? Geo<MODE_UP, 2>::HALO_BYTES : Geo<MODE_UP, 4>::HALO_BYTES;
}

// Output channels a block computes: a Cout of 320 splits over two blocks
// (wgmma's N stops at 256), the others stay whole.
inline int part_of(int cout) { return cout == 320 ? 160 : cout; }

// The stride-2 conv's tensor map: x (B, X, Y, Z, cin) bf16 as dims (cin, Z, Y,
// X, B), a box of 8 channels x 9 x 9 x (BX + 1) voxels taken at every second
// voxel (traversal stride 2: box extent 18, 18, 2 (BX + 1)), zeros outside.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
int encode_down_map(CUtensorMap* map, const void* x, int B, int X, int Y, int Z, int cin, int bx) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[5] = {(cuuint64_t)cin, (cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)cin * 2;  // bytes
  const cuuint64_t strides[4] = {row, row * Z, row * Z * Y, row * Z * Y * X};
  const cuuint32_t box[5] = {8, 2 * TZ + 2, 2 * TY + 2, 2 * (cuuint32_t)bx + 2, 1};
  const cuuint32_t estr[5] = {1, 2, 2, 2, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Halo buffers and ring depth for one shape: the transpose keeps all slices
// resident when they fit beside a ring of at least 4 stages, else slices
// stream through two buffers; the k2 transpose always keeps them (0 where
// they do not fit); the stride-2 conv's eight small input-phase units a slice
// stream through four; the ring takes what is left, up to 16 stages. `cout`
// is a block's part of the output channels.
// Returns the dynamic shared memory in bytes, or 0 when not even two stages fit.
int plan_of(int mode, int cin, int cout, int nhp, int& mt, int& nhb, int& nst) {
  mt = tiles_of(mode, cout);
  const int hb = halo_bytes_of(mode, mt);
  const int nk = (cin + KC - 1) / KC;
  const int stage = KC * cout * 2;
  nhb = 2;
  if (mode == MODE_UP && nk > 2 && nk <= MAX_HALO_BUFS &&
      make_layout(hb, nk, cout, 4, nhp).total <= SMEM_LIMIT)
    nhb = nk;
  if (mode == MODE_UP2) {
    if (nk > MAX_HALO_BUFS) return 0;
    nhb = nk;
  }
  if (is_down(mode)) nhb = 4;
  const int fixed = make_layout(hb, nhb, cout, 0, nhp).total;
  nst = (SMEM_LIMIT - fixed) / stage;
  if (nst > MAX_STAGES) nst = MAX_STAGES;
  if (nst < 2) return 0;
  return fixed + nst * stage;
}

template <int MODE, int COUT, int MT, int NSPL = 1>
int launch_one(Args& a, size_t smem, cudaStream_t stream) {
  constexpr int BX = 2 * MT;
  a.nbx = (a.X + BX - 1) / BX;
  a.nby = (a.Y + TY - 1) / TY;
  a.nbz = (a.Z + TZ - 1) / TZ;
  const long long nblk = (long long)a.B * a.nbx * a.nby * a.nbz;
  if (nblk <= 0) return 0;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.nbricks = (int)nblk;
  static int sms = 0;  // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  auto kern = conv3d_wgmma_kernel<MODE, COUT, MT, NSPL>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // with a split, every part of a brick in one wave: NSPL blocks a brick
  const long long want = nblk * NSPL, fit = sms / NSPL * NSPL;
  const unsigned grid = (unsigned)(want < fit ? want : fit);
  kern<<<grid, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of the block that takes the shape, or 0 when
// the wgmma kernel does not take it. mode: 0 SAME, 1 stride 2, 2 transpose,
// 3 stride 2 padded low, 4 k2 transpose; Cout 320 (split over two blocks)
// with 0, 3 and 4 and no head.
int conv3d_wgmma_plan(int mode, int cin, int cout, int nh) {
  if (mode != MODE_SAME && mode != MODE_DOWN && mode != MODE_UP && mode != MODE_DOWN_PAD &&
      mode != MODE_UP2)
    return 0;
  const bool split = cout == 320 && nh == 0 && mode != MODE_DOWN && mode != MODE_UP;
  if (cout != 32 && cout != 64 && cout != 128 && cout != 256 && !split) return 0;
  if (cin <= 0 || cin % 8 != 0 || nh < 0 || (nh > 0 && mode != MODE_SAME)) return 0;
  int mt, nhb, nst;
  return plan_of(mode, cin, part_of(cout), round_up(nh, HEAD_CHUNK), mt, nhb, nst);
}

// mode: 0 SAME 3x3x3, 1 stride-2 conv (pad low 0, high 1; even extents), 2
// stride-2 transpose (all eight phases in one block), 3 stride-2 conv padded
// (1, 1) (out[o] = sum_d W_d x[2o + d - 1]; even extents), 4 kernel-2 stride-2
// transpose (out[2o + p] = W_p x[o]; all eight phases in one block); B, X, Y,
// Z are the input's extents. epi: 0 bias only, 1 LayerNorm + tanh-GELU (SAME
// only, Cout up to 256); nh > 0 adds the f32 head. wp: weights packed (T,
// ceil(cin / 32), 4, cout, 8), T = 27 taps (8 for mode 4), at Cout 320 the two
// halves' images one after the other, (2, T, ceil(cin / 32), 4, 160, 8); hp:
// head packed (3, cout / 8, roundup(nh, 32), 8).
// Returns a cudaError_t code (0 on success).
int conv3d_wgmma_launch(int mode, int epi, const void* x, const void* wp, const void* bias,
                        const void* ln_g, const void* ln_b, const void* hp, const void* head_b,
                        void* out, int B, int X, int Y, int Z, int cin, int cout, int nh,
                        void* stream) {
  if (mode != MODE_SAME && (epi != EPI_BIAS || nh != 0)) return (int)cudaErrorInvalidValue;
  if (nh > 0 && epi != EPI_LN_GELU) return (int)cudaErrorInvalidValue;
  if (cout == 320 && epi != EPI_BIAS) return (int)cudaErrorInvalidValue;
  if (is_down(mode) && (X % 2 || Y % 2 || Z % 2)) return (int)cudaErrorInvalidValue;
  if (conv3d_wgmma_plan(mode, cin, cout, nh) == 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.wp = static_cast<const __nv_bfloat16*>(wp);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.hp = static_cast<const __nv_bfloat16*>(hp);
  a.head_b = static_cast<const float*>(head_b);
  a.out = out;
  const int s = is_down(mode) ? 2 : 1;
  a.B = B; a.X = X / s; a.Y = Y / s; a.Z = Z / s;
  a.cin = cin; a.cout = cout; a.nh = nh; a.nhp = round_up(nh, HEAD_CHUNK); a.epi = epi;
  int mt;
  const size_t smem = (size_t)plan_of(mode, cin, part_of(cout), a.nhp, mt, a.nhb, a.nst);
  if (is_down(mode)) {
    const int rc = encode_down_map(&a.tmap, x, B, X, Y, Z, cin, 2 * mt);
    if (rc != 0) return rc;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cout == 320) {
    if (mode == MODE_SAME) return launch_one<MODE_SAME, 160, 1, 2>(a, smem, st);
    if (mode == MODE_DOWN_PAD) return launch_one<MODE_DOWN_PAD, 160, 1, 2>(a, smem, st);
    return launch_one<MODE_UP2, 160, 1, 2>(a, smem, st);
  }
  if (mode == MODE_DOWN_PAD) {
    switch (cout) {
      case 32: return launch_one<MODE_DOWN_PAD, 32, 4>(a, smem, st);
      case 64: return launch_one<MODE_DOWN_PAD, 64, 4>(a, smem, st);
      case 128: return launch_one<MODE_DOWN_PAD, 128, 2>(a, smem, st);
      default: return launch_one<MODE_DOWN_PAD, 256, 1>(a, smem, st);
    }
  }
  if (mode == MODE_UP2) {
    switch (cout) {
      case 32: return launch_one<MODE_UP2, 32, 2>(a, smem, st);
      case 64: return launch_one<MODE_UP2, 64, 2>(a, smem, st);
      case 128: return launch_one<MODE_UP2, 128, 1>(a, smem, st);
      default: return launch_one<MODE_UP2, 256, 1>(a, smem, st);
    }
  }
  if (mode == MODE_SAME) {
    switch (cout) {
      case 32: return launch_one<MODE_SAME, 32, 4>(a, smem, st);
      case 64: return launch_one<MODE_SAME, 64, 4>(a, smem, st);
      case 128: return launch_one<MODE_SAME, 128, 2>(a, smem, st);
      default: return launch_one<MODE_SAME, 256, 1>(a, smem, st);
    }
  }
  if (mode == MODE_DOWN) {
    switch (cout) {
      case 32: return launch_one<MODE_DOWN, 32, 4>(a, smem, st);
      case 64: return launch_one<MODE_DOWN, 64, 4>(a, smem, st);
      case 128: return launch_one<MODE_DOWN, 128, 2>(a, smem, st);
      default: return launch_one<MODE_DOWN, 256, 1>(a, smem, st);
    }
  }
  switch (cout) {
    case 32: return launch_one<MODE_UP, 32, 2>(a, smem, st);
    case 64: return launch_one<MODE_UP, 64, 2>(a, smem, st);
    case 128: return launch_one<MODE_UP, 128, 1>(a, smem, st);
    default: return launch_one<MODE_UP, 256, 1>(a, smem, st);
  }
}

#ifdef CONV3D_TIMING
int conv3d_wgmma_debug_read(long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_dbg, sizeof(long long) * 64);
}
#endif

const char* conv3d_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
