// Mean pooling of the dense step's class maps to mag 2, from the packed
// patched head output, for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package pools each tile on the host
// (syconn_tpu/io/chunked.py, `_save_multi_mag`), and so did the port. The
// maps lie on the card as uint8 before their download, so the dense step
// driver (inference/dense.py) pools them here and downloads the mag-2 maps
// beside the mag-1 ones.
//
// Input: the packed uint8 output (B, sx, sy, sz, C * px * py * pz), where
// voxel (i * px + a, j * py + b, k * pz + c) of class ch sits at patch
// position (i, j, k), byte ch * pvox + (a * py + b) * pz + c; per batch row
// the crop extent (X, Y, Z) of the tile inside the volume; the classes to
// pool. Output: (B, K, hx, hy, hz) uint8 with hx = ceil(sx * px / 2) and so
// on, class-major, so that each class of each tile is one block. Inside
// ceil(extent / 2) each value is (sum of the 2x2x2 voxels) >> 3, with voxel
// indices clamped to extent - 1 on each axis: the host's float32 mean of an
// edge-padded tile, truncated to uint8, is exactly that integer (the sum is
// at most 2040, the division by a power of two). Outside, and in a row whose
// extent is 0 on some axis (a row that only pads the batch), it is 0.
//
// What bounds it on this card: bytes. It reads the packed tile once and
// writes an eighth of it per pooled class; a thread takes one output
// position, computes the eight source offsets once (any patch: it indexes by
// voxel coordinate, so a block may span two patch positions) and reads them
// for each class. Neighbouring threads take neighbouring z positions, so the
// stores are coalesced and the loads of a warp fall in one run of packed
// positions.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
pool_mag2_kernel(const uint8_t* __restrict__ packed, const int* __restrict__ meta,
                 uint8_t* __restrict__ out, int B, int sx, int sy, int sz, int C, int px,
                 int py, int pz, int K, int hx, int hy, int hz) {
  const long long n = (long long)B * hx * hy * hz;
  const long long plane = (long long)hx * hy * hz;
  const int pvox = px * py * pz;
  const int* classes = meta + 3 * B;
  for (long long t = (long long)blockIdx.x * NTHREADS + threadIdx.x; t < n;
       t += (long long)gridDim.x * NTHREADS) {
    const int oz = (int)(t % hz);
    long long r = t / hz;
    const int oy = (int)(r % hy);
    r /= hy;
    const int ox = (int)(r % hx);
    const int b = (int)(r / hx);
    const int ex = meta[3 * b], ey = meta[3 * b + 1], ez = meta[3 * b + 2];
    uint8_t* dst = out + (long long)b * K * plane + ((long long)ox * hy + oy) * hz + oz;
    if (2 * ox >= ex || 2 * oy >= ey || 2 * oz >= ez) {
      for (int k = 0; k < K; ++k) dst[k * plane] = 0;
      continue;
    }
    long long off[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int vx = min(2 * ox + (q >> 2), ex - 1);
      const int vy = min(2 * oy + ((q >> 1) & 1), ey - 1);
      const int vz = min(2 * oz + (q & 1), ez - 1);
      const int ix = vx / px, iy = vy / py, iz = vz / pz;
      const long long pos = (((long long)b * sx + ix) * sy + iy) * sz + iz;
      off[q] = pos * C * pvox + ((vx - ix * px) * py + (vy - iy * py)) * pz + (vz - iz * pz);
    }
    for (int k = 0; k < K; ++k) {
      const uint8_t* src = packed + (long long)classes[k] * pvox;
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += src[off[q]];
      dst[k * plane] = (uint8_t)(sum >> 3);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t as int (0 = launched). `meta`
// is int32 on the card: B rows of (X, Y, Z) crop extents, then the K class
// indices (checked by ops/pool.py: extents within the tile, classes below C).
int pool_mag2_launch(const void* packed, const void* meta, void* out, int B, int sx, int sy,
                     int sz, int C, int px, int py, int pz, int K, void* stream) {
  if (B < 1 || sx < 1 || sy < 1 || sz < 1 || C < 1 || px < 1 || py < 1 || pz < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  const int hx = (sx * px + 1) / 2, hy = (sy * py + 1) / 2, hz = (sz * pz + 1) / 2;
  const long long n = (long long)B * hx * hy * hz;
  const long long blocks = (n + NTHREADS - 1) / NTHREADS;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  pool_mag2_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int*)meta, (uint8_t*)out, B, sx, sy, sz, C, px, py, pz, K,
      hx, hy, hz);
  return (int)cudaGetLastError();
}

const char* pool_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
