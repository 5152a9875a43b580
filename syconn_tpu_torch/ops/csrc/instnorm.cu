// Instance normalisation + LeakyReLU for Hopper (sm_90a), plain C interface:
// nnU-Net's InstanceNorm3d(affine) + LeakyReLU between two convolutions.
//
// Replaces no TPU kernel: the JAX package has no nnU-Net. The plain version
// is ops/instnorm.py, `instance_norm_lrelu_ref`.
//
// x (B, S, C) bf16 channels-last (S = X * Y * Z voxels), gamma and beta (C)
// f32 -> y (B, S, C) bf16:
//   mean, var = the mean and the biased variance of x[b, :, c] over S, in f32;
//   scale = gamma[c] / sqrt(var + eps), shift = beta[c] - mean * scale;
//   y = LReLU(x * scale + shift) (slope for y < 0), rounded to bf16.
//
// Statistics: a single pass of E[x^2] - mean^2 in f32 over a tile's 2M voxels
// loses the variance to cancellation wherever |mean| >> std. So every thread
// keeps Welford's running mean and M2 over its voxels (one reciprocal a voxel,
// shared by its 8 channels), the threads of a block and then the blocks of a
// sample combine theirs by Chan's pairwise formula. The last block of a
// sample (a ticket counter in device memory, reset by that block) combines
// the blocks' partials and writes scale and shift.
//
// What bounds it on this card: bytes. The two kernels read x twice and write
// y once (a 128^3 x 32 tile batch of 4: 537 MB read twice, 537 MB written);
// the arithmetic is a few operations a byte. Design:
//   * stats: a block per (chunk of voxels, sample); C / 8 threads a voxel
//     row, each with one 16-byte load of 8 channels, four loads in flight a
//     thread before their Welford updates;
//   * apply: per sample a grid-stride loop over 16-byte vectors, four in
//     flight a thread, streaming loads and stores; scale and shift are read
//     through the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STATS_THREADS = 256;  // at most: a block is (C / 8) x V threads
constexpr int APPLY_THREADS = 256;
constexpr int UNROLL = 4;           // 16-byte loads in flight a thread
constexpr int BLOCKS_PER_SM = 4;    // stats blocks per SM, over all samples

struct Welford {
  float n, mean, m2;
};

__device__ __forceinline__ void chan(Welford& a, const Welford& b) {
  if (b.n == 0.f) return;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  a.mean += d * f;
  a.m2 += b.m2 + d * d * a.n * f;
  a.n = n;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Block (chunk, b): Welford over voxels [chunk * vpc, min(S, (chunk + 1) * vpc))
// of sample b. Thread t: channel group g = t % G (8 channels), voxel lane
// t / G. Partials (n, mean, M2) go to part[((b * nchunk + chunk) * C + c) * 3].
__global__ void __launch_bounds__(STATS_THREADS)
instnorm_stats_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* part, float* stats,
                      unsigned* ticket, long long S, int C, int V, long long vpc, int nchunk,
                      float eps) {
  extern __shared__ float sm[];  // per thread 8 x (mean, M2) + n; reused below
  __shared__ unsigned s_last;
  const int G = C / 8;
  const int tid = threadIdx.x;
  const int T = G * V;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int g = tid % G, lane = tid / G;
  const long long v0 = (long long)chunk * vpc;
  const long long v1 = min(S, v0 + vpc);
  const __nv_bfloat16* xb = x + (long long)b * S * C + g * 8;

  float mean[8], m2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mean[j] = m2[j] = 0.f;
  float n = 0.f;
  if (tid < T) {
    long long v = v0 + lane;
    for (; v + (UNROLL - 1) * V < v1; v += UNROLL * V) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        raw[u] = *reinterpret_cast<const uint4*>(xb + (v + u * V) * C);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float f[8];
        unpack8(raw[u], f);
        n += 1.f;
        const float inv = 1.f / n;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean[j];
          mean[j] += d * inv;
          m2[j] += d * (f[j] - mean[j]);
        }
      }
    }
    for (; v < v1; v += V) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(xb + v * C), f);
      n += 1.f;
      const float inv = 1.f / n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean[j];
        mean[j] += d * inv;
        m2[j] += d * (f[j] - mean[j]);
      }
    }
  }
  // the block's lanes of each channel, combined in lane order
  float* s_mean = sm;               // [T][8]
  float* s_m2 = sm + T * 8;         // [T][8]
  float* s_n = sm + T * 16;         // [T]
  if (tid < T) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_mean[tid * 8 + j] = mean[j];
      s_m2[tid * 8 + j] = m2[j];
    }
    s_n[tid] = n;
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const int gc = c / 8, j = c % 8;
    Welford w{s_n[gc], s_mean[gc * 8 + j], s_m2[gc * 8 + j]};
    for (int l = 1; l < V; ++l) {
      const int t = l * G + gc;
      chan(w, Welford{s_n[t], s_mean[t * 8 + j], s_m2[t * 8 + j]});
    }
    float* p = part + (((long long)b * nchunk + chunk) * C + c) * 3;
    p[0] = w.n;
    p[1] = w.mean;
    p[2] = w.m2;
  }
  // the last block of sample b combines the chunks' partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket + b, 1u) == (unsigned)(nchunk - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int J = blockDim.x >= C ? blockDim.x / C : 1;  // partial sums a channel
  for (int i = tid; i < J * C; i += blockDim.x) {
    const int c = i % C, j = i / C;
    Welford w{0.f, 0.f, 0.f};
    for (int k = j; k < nchunk; k += J) {
      const float* p = part + (((long long)b * nchunk + k) * C + c) * 3;
      chan(w, Welford{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2)});
    }
    sm[i * 3] = w.n;
    sm[i * 3 + 1] = w.mean;
    sm[i * 3 + 2] = w.m2;
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    Welford w{sm[c * 3], sm[c * 3 + 1], sm[c * 3 + 2]};
    for (int j = 1; j < J; ++j)
      chan(w, Welford{sm[(j * C + c) * 3], sm[(j * C + c) * 3 + 1], sm[(j * C + c) * 3 + 2]});
    const float var = w.m2 / w.n;
    const float scale = gamma[c] / sqrtf(var + eps);
    stats[((long long)b * C + c) * 2] = scale;
    stats[((long long)b * C + c) * 2 + 1] = beta[c] - w.mean * scale;
  }
  if (tid == 0) ticket[b] = 0u;  // every block of the sample has taken its ticket
}

__device__ __forceinline__ uint4 norm8(const uint4& v, const float* st, float slope) {
  float f[8];
  unpack8(v, f);
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(st));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(st + 4));
  const float4 s2 = __ldg(reinterpret_cast<const float4*>(st + 8));
  const float4 s3 = __ldg(reinterpret_cast<const float4*>(st + 12));
  const float sc[8] = {s0.x, s0.z, s1.x, s1.z, s2.x, s2.z, s3.x, s3.z};
  const float sh[8] = {s0.y, s0.w, s1.y, s1.w, s2.y, s2.w, s3.y, s3.w};
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float a = f[2 * i] * sc[2 * i] + sh[2 * i];
    float c = f[2 * i + 1] * sc[2 * i + 1] + sh[2 * i + 1];
    a = a < 0.f ? a * slope : a;
    c = c < 0.f ? c * slope : c;
    __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
    o[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return out;
}

// y = LReLU(x * scale + shift) over sample blockIdx.y, 16-byte vectors;
// vector i of the sample holds channels 8 (i % G) .. 8 (i % G) + 7 of voxel i / G.
__global__ void __launch_bounds__(APPLY_THREADS)
instnorm_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ stats,
                      __nv_bfloat16* __restrict__ y, int nv, int C, float slope) {
  const int G = C / 8;
  const long long base = (long long)blockIdx.y * nv;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + base;
  uint4* yv = reinterpret_cast<uint4*>(y) + base;
  const float* st = stats + (long long)blockIdx.y * C * 2;
  const int step = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i < nv - (UNROLL - 1) * step; i += UNROLL * step) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) raw[u] = __ldcs(xv + i + u * step);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = i + u * step;
      __stcs(yv + k, norm8(raw[u], st + (k % G) * 16, slope));
    }
  }
  for (; i < nv; i += step) __stcs(yv + i, norm8(__ldcs(xv + i), st + (i % G) * 16, slope));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// voxel lanes a stats block, voxels a chunk, chunks a sample
void plan(int B, long long S, int C, int& V, long long& vpc, int& nchunk) {
  const int G = C / 8;
  V = STATS_THREADS / G > 0 ? STATS_THREADS / G : 1;
  const long long want = ((long long)sm_count() * BLOCKS_PER_SM + B - 1) / B;
  const long long q = (long long)V * UNROLL;  // whole unrolled steps a chunk
  vpc = (S + want - 1) / want;
  vpc = (vpc + q - 1) / q * q;
  nchunk = (int)((S + vpc - 1) / vpc);
}

}  // namespace

extern "C" {

// Floats of workspace one call takes (the blocks' partials, then scale and
// shift), or 0 for a shape the kernels do not take (C % 8, C > 8 * 256).
long long instnorm_workspace(int B, long long S, int C) {
  if (B < 1 || B > 65535 || S < 1 || C < 8 || C % 8 || C / 8 > STATS_THREADS ||
      S * (C / 8) > 0x7fffffffLL)
    return 0;
  int V, nchunk;
  long long vpc;
  plan(B, S, C, V, vpc, nchunk);
  return (long long)B * nchunk * C * 3 + (long long)B * C * 2;
}

// x, y: (B, S, C) bf16, 16-byte aligned; gamma, beta: (C) f32; ws: the floats
// instnorm_workspace gives; ticket: B zeroed uint32 (left zeroed). Launches the
// two kernels on `stream`; returns a cudaError_t as int (0 = launched).
int instnorm_launch(const void* x, const void* gamma, const void* beta, void* y, void* ws,
                    void* ticket, int B, long long S, int C, float eps, float slope,
                    void* stream) {
  if (instnorm_workspace(B, S, C) == 0) return (int)cudaErrorInvalidValue;
  int V, nchunk;
  long long vpc;
  plan(B, S, C, V, vpc, nchunk);
  const int G = C / 8, T = G * V;
  float* part = static_cast<float*>(ws);
  float* stats = part + (long long)B * nchunk * C * 3;
  const int J = T >= C ? T / C : 1;
  const size_t smem = (size_t)4 * (T * 17 > J * C * 3 ? T * 17 : J * C * 3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  instnorm_stats_kernel<<<dim3(nchunk, B), T, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), part, stats, static_cast<unsigned*>(ticket), S, C, V, vpc,
      nchunk, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nv = (int)(S * G);
  long long grid = (nv + APPLY_THREADS * UNROLL - 1) / (APPLY_THREADS * UNROLL);
  const long long cap = ((long long)sm_count() * 8 + B - 1) / B;
  if (grid > cap) grid = cap;
  instnorm_apply_kernel<<<dim3((unsigned)grid, B), APPLY_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), stats, static_cast<__nv_bfloat16*>(y), nv, C, slope);
  return (int)cudaGetLastError();
}

const char* instnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
