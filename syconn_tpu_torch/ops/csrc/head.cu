// The dense step's head for Hopper (sm_90a), plain C interface: crop, class
// softmax and quantise (or threshold and bit-pack) of the U-Net engine's
// packed f32 logits in one pass.
//
// Replaces no TPU kernel: the JAX package's head (syconn_tpu/inference/
// dense.py, `fwd`, after `apply_packed`) is plain jnp that XLA fuses. Its
// plain PyTorch form (ops/head.py, `dense_head_ref`) is five passes on the
// card: the crop, the contiguous copy that `torch.softmax` makes of it, the
// softmax over the class axis (at a stride of pvox), `* 255` and round, and
// the cast (or the compare and the bit-pack).
//
// Input: the engine's logits (B, SX, SY, SZ, N), N = C * pvox (a multiple of
// 4; of 8 for masks), channel c * pvox + v = class c at patch voxel v,
// contiguous. Output: the cropped
// (B, sx, sy, sz, N) uint8 probabilities, or (B, sx, sy, sz, N / 8) uint8
// masks whose byte j, bit k holds channel 8j + k.
//
// Arithmetic, per position and patch voxel v, in f32 without fast math, as
// PyTorch's spatial softmax computes it for a class axis this short (one
// thread per (position, v), classes in order): m = max over c of x_c;
// sum = 0 + e_0 + e_1 + ... with e_c = expf(x_c - m); p_c = e_c / sum (IEEE
// division); probs: rint(p_c * 255) (half to even, as torch.round); masks:
// bit set where p_c >= thr[c]. The aim is the plain head's bytes.
//
// What bounds it on this card: bytes. One read of the cropped logits and one
// write of the uint8 result (an organelles tile: 134 MB + 33.5 MB; a
// syntype tile: 101 MB + 25.2 MB); the exps and IEEE divisions come to about
// half the memory time, so they have to overlap it. Design:
//
//   * one block of NTHREADS threads per piece of a z-run of cropped
//     positions (b, x, y, z0 .. z0 + P): in the haloed tensor such a piece is
//     contiguous (P * N floats; the organelles tile's whole run is 8 KB, the
//     syntype tile's 24 KB), so it is copied into shared memory as 16-byte
//     cp.async vectors, every load of the block in flight at once;
//   * in shared memory a position takes S >= N floats, S = pvox (mod 32)
//     where pvox < 32: the 32 / pvox positions that one warp's lanes read
//     then lie on distinct banks (organelles: S = 40, not 32);
//   * each thread then owns (position, v) pairs, v fastest, and reads its C
//     logits at a stride of pvox; the template specialisations for (C, pvox)
//     = (4, 8), (3, 32) and (4, 1) (nnU-Net) keep them in registers, the
//     generic loop reads shared memory once a class and pass;
//   * the uint8 result is assembled in shared memory (masks: 32-bit atomicOr
//     of the bits) and written as 16-byte vectors where the piece's output
//     is 16-byte aligned (both configurations), else in 4-byte or 1-byte
//     stores;
//   * several blocks share an SM (10 organelles blocks, bounded by their 42
//     registers; 7 syntype blocks, by their 30 KB of shared memory), so one
//     block's loads overlap another's arithmetic and stores.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NTHREADS = 128;
constexpr int MODE_PROBS = 0;
constexpr int MODE_MASKS = 1;
// shared memory a block may take without cudaFuncAttributeMaxDynamicSharedMemorySize
constexpr int MAX_SMEM = 48 * 1024;

struct Dims {
  int SX, SY, SZ;  // haloed positions
  int hx, hy, hz;  // crop start
  int sx, sy, sz;  // crop extent
  int C, pvox;
  int P;           // positions a block (a piece of a z-run)
  int S;           // floats a position takes in shared memory
  int nzc;         // pieces a z-run
  int ob;          // output bytes a position
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MODE>
__device__ __forceinline__ void emit(unsigned char* s_out, int bit, float p, float thr) {
  if constexpr (MODE == MODE_PROBS) {
    s_out[bit] = static_cast<unsigned char>(__float2uint_rn(p * 255.0f));
  } else if (p >= thr) {
    atomicOr(reinterpret_cast<unsigned*>(s_out) + (bit >> 5), 1u << (bit & 31));
  }
}

// CT, PT: the class count and patch voxels when fixed at compile time, else 0
template <int CT, int PT, int MODE>
__global__ void __launch_bounds__(NTHREADS)
dense_head_kernel(const float* __restrict__ lg, const float* __restrict__ thr,
                  unsigned char* __restrict__ out, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_in = reinterpret_cast<float*>(smem);
  unsigned char* s_out = smem + static_cast<size_t>(d.P) * d.S * 4;
  const int C = CT ? CT : d.C;
  const int pv = PT ? PT : d.pvox;
  const int N = C * pv;

  long long u = blockIdx.x;
  const int zc = static_cast<int>(u % d.nzc);
  u /= d.nzc;
  const int y = static_cast<int>(u % d.sy);
  u /= d.sy;
  const int x = static_cast<int>(u % d.sx);
  const long long b = u / d.sx;
  const int z0 = zc * d.P;
  const int np = min(d.P, d.sz - z0);

  // the piece's logits: np * N contiguous floats (N % 4 == 0, so every
  // position starts 16-byte aligned)
  const long long pin = ((b * d.SX + d.hx + x) * d.SY + d.hy + y) * d.SZ + d.hz + z0;
  const float* src = lg + pin * N;
  const int vpp = N / 4;
  for (int i = threadIdx.x; i < np * vpp; i += NTHREADS) {
    const int p = i / vpp;
    cp_async16(s_in + p * d.S + 4 * (i - p * vpp), src + 4 * i);
  }
  const int nbytes = np * d.ob;
  if constexpr (MODE == MODE_MASKS) {
    for (int i = threadIdx.x; i < (nbytes + 3) / 4; i += NTHREADS)
      reinterpret_cast<unsigned*>(s_out)[i] = 0u;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int j = threadIdx.x; j < np * pv; j += NTHREADS) {
    const int p = j / pv, v = j - p * pv;
    const float* xs = s_in + p * d.S + v;
    unsigned char* o = s_out;
    const int bit0 = p * N + v;  // probs: the byte; masks: the bit of class 0
    if constexpr (CT > 0) {
      float e[CT];
#pragma unroll
      for (int c = 0; c < C; ++c) e[c] = xs[c * pv];
      float m = e[0];
#pragma unroll
      for (int c = 1; c < C; ++c) m = fmaxf(m, e[c]);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        e[c] = expf(e[c] - m);
        sum += e[c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        emit<MODE>(o, bit0 + c * pv, e[c] / sum, MODE == MODE_MASKS ? __ldg(thr + c) : 0.0f);
    } else {
      float m = xs[0];
      for (int c = 1; c < C; ++c) m = fmaxf(m, xs[c * pv]);
      float sum = 0.0f;
      for (int c = 0; c < C; ++c) sum += expf(xs[c * pv] - m);
      for (int c = 0; c < C; ++c)
        emit<MODE>(o, bit0 + c * pv, expf(xs[c * pv] - m) / sum,
                   MODE == MODE_MASKS ? __ldg(thr + c) : 0.0f);
    }
  }
  __syncthreads();

  const long long pout = ((b * d.sx + x) * d.sy + y) * d.sz + z0;
  unsigned char* dst = out + pout * d.ob;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(nbytes);
  if ((align & 15) == 0) {
    for (int i = threadIdx.x; i < nbytes / 16; i += NTHREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(s_out)[i];
  } else if ((align & 3) == 0) {
    for (int i = threadIdx.x; i < nbytes / 4; i += NTHREADS)
      reinterpret_cast<unsigned*>(dst)[i] = reinterpret_cast<const unsigned*>(s_out)[i];
  } else {
    for (int i = threadIdx.x; i < nbytes; i += NTHREADS) dst[i] = s_out[i];
  }
}

template <int CT, int PT, int MODE>
int launch(const float* lg, const float* thr, unsigned char* out, const Dims& d, long long grid,
           int smem, cudaStream_t stream) {
  auto kernel = dense_head_kernel<CT, PT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<static_cast<unsigned>(grid), NTHREADS, smem, stream>>>(lg, thr, out, d);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const float* lg, const float* thr, unsigned char* out, const Dims& d,
             long long grid, int smem, cudaStream_t stream) {
  if (d.C == 4 && d.pvox == 8) return launch<4, 8, MODE>(lg, thr, out, d, grid, smem, stream);
  if (d.C == 3 && d.pvox == 32) return launch<3, 32, MODE>(lg, thr, out, d, grid, smem, stream);
  if (d.C == 4 && d.pvox == 1) return launch<4, 1, MODE>(lg, thr, out, d, grid, smem, stream);
  return launch<0, 0, MODE>(lg, thr, out, d, grid, smem, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t as int (0 = launched). The
// piece length P and the shared-memory stride S come from ops/head.py
// (`head_plan`); what the kernel does not take is cudaErrorInvalidValue.
int dense_head_launch(const void* lg, const void* thr, void* out, int B, int SX, int SY, int SZ,
                      int C, int pvox, int hx, int hy, int hz, int sx, int sy, int sz, int mode,
                      int P, int S, void* stream) {
  const long long N = static_cast<long long>(C) * pvox;
  if (B < 1 || C < 1 || pvox < 1 || N % 4 || (mode == MODE_MASKS && N % 8) || sx < 1 || sy < 1 || sz < 1 || hx < 0 || hy < 0 ||
      hz < 0 || hx + sx > SX || hy + sy > SY || hz + sz > SZ || P < 1 || P > sz || S < N ||
      S % 4 || (mode != MODE_PROBS && mode != MODE_MASKS) || (mode == MODE_MASKS && !thr))
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.SX = SX; d.SY = SY; d.SZ = SZ;
  d.hx = hx; d.hy = hy; d.hz = hz;
  d.sx = sx; d.sy = sy; d.sz = sz;
  d.C = C; d.pvox = pvox;
  d.P = P; d.S = S;
  d.nzc = (sz + P - 1) / P;
  d.ob = static_cast<int>(mode == MODE_PROBS ? N : N / 8);
  const long long in_bytes = static_cast<long long>(P) * S * 4;
  const long long smem = in_bytes + (static_cast<long long>(P) * d.ob + 15) / 16 * 16;
  const long long grid = static_cast<long long>(B) * sx * sy * d.nzc;
  if (smem > MAX_SMEM || grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(lg);
  const float* t = static_cast<const float*>(thr);
  unsigned char* o = static_cast<unsigned char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == MODE_PROBS) return dispatch<MODE_PROBS>(x, t, o, d, grid, (int)smem, st);
  return dispatch<MODE_MASKS>(x, t, o, d, grid, (int)smem, st);
}

const char* dense_head_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
