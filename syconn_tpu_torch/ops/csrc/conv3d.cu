// Hand-written Hopper (sm_90a) mma.sync kernel for the dense U-Net's SAME
// 3x3x3 convolution, for the shapes the wgmma kernel of conv3d_wgmma.cu does
// not take.
//
// Replaces, for those shapes, the Pallas TPU kernel conv3x3x3_ln_gelu of
// syconn_tpu/ops/conv3d_pallas.py (:70): SAME 3x3x3 conv + bf16 bias, then
// either nothing ("bias"), or LayerNorm + tanh-GELU, optionally followed by a
// fused f32 1x1x1 head. Served here only when the head's three bf16 parts do
// not fit the wgmma kernel's shared memory (e.g. Cout 256 with 96 logits); no
// shape of the dense-prediction main path. (The stride-2 conv and the
// transpose run in conv3d_wgmma.cu for every shape.)
//
// One implicit-GEMM template. A block owns a 4x4x4
// brick of output rows (64 rows) times ALL output channels (<= 256), so the
// per-position LayerNorm over channels finishes in the epilogue and the conv
// output never round-trips device memory. Per 32-channel slice of the input
// the block stages the brick's input halo in shared memory once and reuses it
// for every tap; the per-tap (32 x Cout) weight slice is double-buffered with
// cp.async. Products are bf16 mma.sync.m16n8k16 with f32 accumulation; A rows
// are gathered from the halo with ldmatrix (one row address per lane), B with
// ldmatrix.trans.
//
// Bound on the H100: a 3x3x3 conv at these widths does ~27*Cout/2 FLOP per
// input byte, far above the ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations. This kernel uses mma.sync (not wgmma) with a barrier
// per tap and a 64-row block, so it runs well below that bound (3-4x slower
// than cuDNN); the design keeps the halo in shared memory to spend its
// bandwidth on operands that are reused.
//
// Epilogue op order follows the Pallas kernel exactly (conv3d_pallas.py:196-214):
//   round f32 acc to bf16 -> add bf16 bias in bf16 -> [LayerNorm in f32,
//   var = E[x^2] - mu^2, eps 1e-6 -> tanh-GELU in f32 -> cast bf16]
//   -> [head: f32 matmul on the bf16-rounded activation + f32 bias].
//
// Plain C interface (loaded with ctypes by syconn_tpu_torch/ops/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;        // input channels per staged slice
constexpr int KP = KC + 8;    // halo row pitch in elements (80 B: ldmatrix rows spread over banks)
constexpr int BR = 4;         // brick edge
constexpr int BM = BR * BR * BR;  // 64 output rows per block
constexpr int NTHREADS = 256; // 8 warps: 4 along rows (16 each) x 2 along channels

enum Mode { MODE_SAME = 0 };
enum Epi { EPI_BIAS = 0, EPI_LN_GELU = 1 };

struct Args {
  const __nv_bfloat16* x;     // (B, X, Y, Z, cin)
  const __nv_bfloat16* w;     // (27, cin, cout)
  const __nv_bfloat16* bias;  // (cout)
  const float* ln_g;          // (cout) or null
  const float* ln_b;          // (cout) or null
  const float* head_w;        // (cout, nh) or null
  const float* head_b;        // (nh) or null
  void* out;                  // bf16 (B, OX, OY, OZ, cout) or f32 (..., nh)
  int B, X, Y, Z;             // input extents (= output extents, the row space)
  int cin, cout, nh, epi;
  int nbx, nby, nbz;          // bricks per axis
};

// Halo edge: a row at brick coordinate r reads, for tap d, the halo element
// at r + d; the halo starts one row below the brick.
constexpr int HE = BR + 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu_tanh(float y) {
  // jax.nn.gelu(approximate=True)
  const float k = 0.7978845608028654f;  // sqrt(2/pi)
  return y * (0.5f * (1.0f + tanhf(k * (y + 0.044715f * (y * y * y)))));
}

// Flat weight tap t -> halo index delta.
__device__ __forceinline__ int tap_delta(int t) {
  const int dx = t / 9, dy = (t / 3) % 3, dz = t % 3;
  return (dx * HE + dy) * HE + dz;
}

template <int NT>
__global__ void __launch_bounds__(NTHREADS) conv3d_kernel(const Args a) {
  constexpr int HP = HE * HE * HE;
  constexpr int COUT = NT * 16;
  constexpr int BP = COUT + 8;  // weight row pitch (elements)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bsm = halo + HP * KP;  // 2 x (KC x BP)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;

  int blk = blockIdx.x;
  const int bz = blk % a.nbz; blk /= a.nbz;
  const int by = blk % a.nby; blk /= a.nby;
  const int bx = blk % a.nbx; blk /= a.nbx;
  const int b = blk;
  const int r0x = bx * BR, r0y = by * BR, r0z = bz * BR;
  const int hx0 = r0x - 1, hy0 = r0y - 1, hz0 = r0z - 1;

  constexpr int ntap = 27;
  const int cin = a.cin;
  const int nk = (cin + KC - 1) / KC;
  const int nsteps = nk * ntap;

  // ldmatrix row of this lane (A operand): row wm*16 + (lane & 15) of the brick
  const int arow = wm * 16 + (lane & 15);
  const int arx = arow >> 4, ary = (arow >> 2) & 3, arz = arow & 3;
  const int ahb = (arx * HE + ary) * HE + arz;
  const int acol = (lane >> 4) * 8;

  const __nv_bfloat16* xb = a.x + (size_t)b * a.X * a.Y * a.Z * cin;

  auto load_halo = [&](int kc) {
    const int c0 = kc * KC;
    for (int i = tid; i < HP * (KC / 8); i += NTHREADS) {
      const int p = i >> 2, v = i & 3;
      const int hz = p % HE, hy = (p / HE) % HE, hx = p / (HE * HE);
      const int gx = hx0 + hx, gy = hy0 + hy, gz = hz0 + hz;
      const int c = c0 + v * 8;
      __nv_bfloat16* dst = halo + p * KP + v * 8;
      if (gx >= 0 && gx < a.X && gy >= 0 && gy < a.Y && gz >= 0 && gz < a.Z && c < cin) {
        cp_async16(dst, xb + (((size_t)gx * a.Y + gy) * a.Z + gz) * cin + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto load_b = [&](int s, int buf) {
    const int kc = s / ntap, t = s % ntap;
    const int c0 = kc * KC;
    const __nv_bfloat16* src = a.w + ((size_t)t * cin + c0) * COUT;
    __nv_bfloat16* dst = bsm + buf * (KC * BP);
    constexpr int NV = COUT / 8;
    for (int i = tid; i < KC * NV; i += NTHREADS) {
      const int k = i / NV, v = i % NV;
      __nv_bfloat16* d = dst + k * BP + v * 8;
      if (c0 + k < cin) {
        cp_async16(d, src + (size_t)k * COUT + v * 8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  load_b(0, 0);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    const int ti = s % ntap;
    if (ti == 0) {
      __syncthreads();  // every warp is done reading the previous halo slice
      load_halo(s / ntap);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();  // halo + weights of step s visible; step s-1 done everywhere
    if (s + 1 < nsteps) {
      load_b(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const int delta = tap_delta(ti);
    const __nv_bfloat16* bs = bsm + (s & 1) * (KC * BP);
    const __nv_bfloat16* arow_p = halo + (ahb + delta) * KP + acol;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3, arow_p + ks * 16);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b0, b1, b2, b3;
        const __nv_bfloat16* bp =
            bs + (ks * 16 + (lane & 15)) * BP + wn * (NT * 8) + j * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b0, b1, b2, b3, bp);
        mma_bf16(acc[2 * j], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * j + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }
  __syncthreads();  // main-loop shared memory is reused for the epilogue

  // stage bf16(acc) + bf16 bias (exact bf16 values, kept as f32)
  constexpr int ES = COUT + 4;
  float* E = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = wn * (NT * 8) + n * 8 + tq * 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = wm * 16 + g + ((q >> 1) << 3);
        const int c = col + (q & 1);
        E[r * ES + c] = __bfloat162float(__hadd(__float2bfloat16(acc[n][q]), a.bias[c]));
      }
    }
  }
  __syncthreads();

  // row-wise epilogue: warp w owns rows 8w .. 8w+7
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int qx = r0x + (r >> 4), qy = r0y + ((r >> 2) & 3), qz = r0z + (r & 3);
    if (qx >= a.X || qy >= a.Y || qz >= a.Z) continue;  // warp-uniform
    const size_t orow = (((size_t)b * a.X + qx) * a.Y + qy) * a.Z + qz;
    float* er = E + r * ES;
    if (a.epi == EPI_BIAS) {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out) + orow * COUT;
      for (int c = lane; c < COUT; c += 32) o[c] = __float2bfloat16(er[c]);
      continue;
    }
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < COUT; c += 32) {
      const float h = er[c];
      s1 += h;
      s2 += h * h;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
    }
    const float mu = s1 / COUT;
    const float var = s2 / COUT - mu * mu;
    const float rs = rsqrtf(var + 1e-6f);
    if (a.nh == 0) {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out) + orow * COUT;
      for (int c = lane; c < COUT; c += 32) {
        const float y = (er[c] - mu) * rs * a.ln_g[c] + a.ln_b[c];
        o[c] = __float2bfloat16(gelu_tanh(y));
      }
    } else {
      for (int c = lane; c < COUT; c += 32) {
        const float y = (er[c] - mu) * rs * a.ln_g[c] + a.ln_b[c];
        er[c] = __bfloat162float(__float2bfloat16(gelu_tanh(y)));
      }
      __syncwarp();
      float* o = reinterpret_cast<float*>(a.out) + orow * a.nh;
      for (int n = lane; n < a.nh; n += 32) {
        float h = 0.f;
        for (int c = 0; c < COUT; ++c) h = fmaf(er[c], a.head_w[c * a.nh + n], h);
        o[n] = h + a.head_b[n];
      }
      __syncwarp();
    }
  }
}

size_t smem_bytes(int cout) {
  const size_t main = (size_t)HE * HE * HE * KP * 2 + 2 * (size_t)KC * (cout + 8) * 2;
  const size_t epi = (size_t)BM * (cout + 4) * 4;
  return main > epi ? main : epi;
}

int launch(Args& a, cudaStream_t stream) {
  void (*kern)(Args) = nullptr;
  switch (a.cout) {
    case 32: kern = conv3d_kernel<2>; break;
    case 64: kern = conv3d_kernel<4>; break;
    case 128: kern = conv3d_kernel<8>; break;
    case 256: kern = conv3d_kernel<16>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  a.nbx = (a.X + BR - 1) / BR;
  a.nby = (a.Y + BR - 1) / BR;
  a.nbz = (a.Z + BR - 1) / BR;
  const long long nblk = (long long)a.B * a.nbx * a.nby * a.nbz;
  if (nblk <= 0) return 0;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.cout);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(unsigned)nblk, NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 SAME 3x3x3 (the only one; the stride-2 conv runs in conv3d_wgmma.cu).
// epi: 0 bias only, 1 LayerNorm + tanh-GELU; nh > 0 adds the f32 head.
// Returns a cudaError_t code (0 on success).
int conv3d_launch(int mode, int epi, const void* x, const void* w, const void* bias,
                  const void* ln_g, const void* ln_b, const void* head_w, const void* head_b,
                  void* out, int B, int X, int Y, int Z, int cin, int cout, int nh,
                  void* stream) {
  if (mode != MODE_SAME || cin <= 0 || cin % 8 != 0) return (int)cudaErrorInvalidValue;
  if (nh > 0 && epi != EPI_LN_GELU) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.ln_g = static_cast<const float*>(ln_g);
  a.ln_b = static_cast<const float*>(ln_b);
  a.head_w = static_cast<const float*>(head_w);
  a.head_b = static_cast<const float*>(head_b);
  a.out = out;
  a.B = B; a.X = X; a.Y = Y; a.Z = Z;
  a.cin = cin; a.cout = cout; a.nh = nh; a.epi = epi;
  return launch(a, static_cast<cudaStream_t>(stream));
}

const char* conv3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
