// Contact-site window majority vote for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_detect_cs_pallas`
// (syconn_tpu/ops/contacts_pallas.py:45): for every voxel of an (x, y) tile
// column, over the full z extent, the candidate label that is most frequent
// in the (sx, sy, sz) window around the voxel wins. The voxel's own label, 0
// and INT_MAX never count; ties go to the candidate visited first (the
// candidate table is ascending, so to the smallest label). Output is
// lo = min(center, best), hi = max(center, best) where the best count is
// positive, else 0. All arithmetic is integer: the result equals the plain
// PyTorch version bit for bit.
//
// What bounds it on this card: bytes. The function reads the int32 label
// volume once and writes two int32 volumes; the per-candidate counting is a
// few integer operations per voxel and stays in shared memory. The design
// keeps the whole working set of a block on chip:
//
//   * one block per (column, z-slab of `zs` output planes); the slab's label
//     window (tile + stencil halo) is loaded once and stored as ONE BYTE per
//     voxel: the index of the voxel's label in the column's candidate table
//     (0xFF: not a candidate). A candidate no voxel of the window carries is
//     skipped; its counts would be zero.
//   * per candidate a separable box sum in shared memory: along x into `A`
//     (<= sx, one byte), along y into `B` (<= sx*sy <= 255, one byte), then
//     each thread runs a sliding sum along z over its own (x, y) pencil;
//   * the running best of a pencil lives in registers, one word per plane:
//     (count << 8) | (255 - slot). The maximum of that word over the
//     candidates is the strict-`>` update in visiting order, ties to the
//     lower slot included, so no candidate order is lost.
//
// Nothing of the TPU layout is carried over: no 128-lane z padding, no
// sublane rounding of the window, no banded matmul for the z sum.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int ZS_MAX = 16;          // output planes per block (register file)
constexpr int MAX_THREADS = 1024;   // one thread per (x, y) pencil of the tile
constexpr int MAX_SMEM = 232448;    // dynamic shared memory a block may use
constexpr int LABEL_PAD = 0x7fffffff;
constexpr unsigned char NO_SLOT = 0xFF;

__global__ void __launch_bounds__(MAX_THREADS)
detect_cs_columns_kernel(const int* __restrict__ seg, const int* __restrict__ offs,
                         const int* __restrict__ cands, int* __restrict__ out_lo,
                         int* __restrict__ out_hi, int Xp, int Yp, int Z, int K,
                         int tx, int ty, int sx, int sy, int sz, int zs) {
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = blockIdx.y;
  const int z0 = blockIdx.x * zs;
  const int hx = sx / 2, hy = sy / 2, hz = sz / 2;
  const int WX = tx + sx - 1, WY = ty + sy - 1, WZ = zs + sz - 1;
  const int PL = WY * WZ;  // one x plane of the window

  int* s_cand = reinterpret_cast<int*>(smem);
  int* s_present = s_cand + K;
  unsigned char* win = reinterpret_cast<unsigned char*>(s_present + K);  // [WX][WY][WZ]
  unsigned char* A = win + WX * PL;                                       // [tx][WY][WZ]
  unsigned char* B = A + tx * PL;                                         // [tx][ty][WZ]

  for (int k = tid; k < K; k += nt) {
    s_cand[k] = cands[(int64_t)g * K + k];
    s_present[k] = 0;
  }
  __syncthreads();

  const int ox = offs[2 * g], oy = offs[2 * g + 1];
  // label window -> candidate slots; outside the volume the label is 0
  for (int idx = tid; idx < WX * PL; idx += nt) {
    const int xw = idx / PL, r = idx - xw * PL;
    const int yw = r / WZ, zw = r - yw * WZ;
    const int x = ox + xw, y = oy + yw, z = z0 - hz + zw;
    int label = 0;
    if (x >= 0 && x < Xp && y >= 0 && y < Yp && z >= 0 && z < Z)
      label = seg[((int64_t)x * Yp + y) * Z + z];
    unsigned char slot = NO_SLOT;
    if (label != 0 && label != LABEL_PAD) {
      for (int k = 0; k < K; ++k) {
        if (s_cand[k] == label) {
          slot = (unsigned char)k;
          break;
        }
      }
    }
    win[idx] = slot;
    if (slot != NO_SLOT) s_present[slot] = 1;
  }
  __syncthreads();

  const bool pencil = tid < tx * ty;
  const int px = tid / ty, py = tid - px * ty;
  const int bbase = (px * ty + py) * WZ;
  const int cbase = ((px + hx) * WY + py + hy) * WZ + hz;
  unsigned int best[ZS_MAX];
#pragma unroll
  for (int z = 0; z < ZS_MAX; ++z) best[z] = 0u;

  for (int k = 0; k < K; ++k) {
    const int c = s_cand[k];
    if (c == 0 || c == LABEL_PAD || !s_present[k]) continue;  // uniform per block
    // box sum along x of the candidate's indicator
    for (int idx = tid; idx < tx * PL; idx += nt) {
      int s = 0;
      for (int dx = 0; dx < sx; ++dx) s += (win[idx + dx * PL] == k);
      A[idx] = (unsigned char)s;
    }
    __syncthreads();
    // box sum along y
    const int XB = ty * WZ;
    for (int j = tid; j < tx * XB; j += nt) {
      const int x = j / XB, r = j - x * XB;
      const unsigned char* a = A + x * PL + r;
      int s = 0;
      for (int dy = 0; dy < sy; ++dy) s += a[dy * WZ];
      B[j] = (unsigned char)s;
    }
    __syncthreads();
    // sliding sum along z over this thread's pencil, and the best update
    if (pencil) {
      int run = 0;
      for (int dz = 0; dz < sz - 1; ++dz) run += B[bbase + dz];
      const unsigned int tag = 255u - (unsigned int)k;
#pragma unroll
      for (int z = 0; z < ZS_MAX; ++z) {
        if (z < zs) {
          run += B[bbase + z + sz - 1];
          if (win[cbase + z] != k) {
            const unsigned int key = ((unsigned int)run << 8) | tag;
            best[z] = key > best[z] ? key : best[z];
          }
          run -= B[bbase + z];
        }
      }
    }
    // the next candidate writes B only after the barrier that follows its
    // own x pass, which every thread reaches after finishing this z pass
  }

  if (pencil) {
    const int cx = ox + px + hx, cy = oy + py + hy;
    const bool inside = cx >= 0 && cx < Xp && cy >= 0 && cy < Yp;
    const int64_t obase = (((int64_t)g * tx + px) * ty + py) * Z;
#pragma unroll
    for (int z = 0; z < ZS_MAX; ++z) {
      const int zo = z0 + z;
      if (z < zs && zo < Z) {
        const int center = inside ? seg[((int64_t)cx * Yp + cy) * Z + zo] : 0;
        const unsigned int b = best[z];
        int lo = 0, hi = 0;
        if ((b >> 8) > 0u) {
          const int id = s_cand[255 - (int)(b & 255u)];
          lo = center < id ? center : id;
          hi = center < id ? id : center;
        }
        out_lo[obase + zo] = lo;
        out_hi[obase + zo] = hi;
      }
    }
  }
}

// Shared memory one block needs, in bytes.
int smem_bytes(int K, int tx, int ty, int sx, int sy, int sz, int zs) {
  const int WX = tx + sx - 1, WY = ty + sy - 1, WZ = zs + sz - 1;
  return 2 * K * (int)sizeof(int) + (WX + tx) * WY * WZ + tx * ty * WZ;
}

}  // namespace

extern "C" {

// Launches on `stream` with the deepest z slab (<= ZS_MAX planes) whose
// window fits shared memory; returns a cudaError_t as int (0 = launched).
int detect_cs_columns_launch(const void* seg, const void* offs, const void* cands,
                             void* out_lo, void* out_hi, int Xp, int Yp, int Z, int G,
                             int K, int tx, int ty, int sx, int sy, int sz, void* stream) {
  if (G < 1 || Z < 1 || K < 1 || K > 254 || tx < 1 || ty < 1 || tx * ty > MAX_THREADS ||
      sx < 1 || sy < 1 || sz < 1 || sx * sy > 255 || G > 65535)
    return (int)cudaErrorInvalidValue;
  int zs = Z < ZS_MAX ? Z : ZS_MAX;
  while (zs > 1 && smem_bytes(K, tx, ty, sx, sy, sz, zs) > MAX_SMEM) --zs;
  const int smem = smem_bytes(K, tx, ty, sx, sy, sz, zs);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(detect_cs_columns_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int threads = (tx * ty + 31) / 32 * 32;
  if (threads < 256) threads = 256;
  const dim3 grid((Z + zs - 1) / zs, G);
  detect_cs_columns_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int*)seg, (const int*)offs, (const int*)cands, (int*)out_lo, (int*)out_hi,
      Xp, Yp, Z, K, tx, ty, sx, sy, sz, zs);
  return (int)cudaGetLastError();
}

const char* contacts_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
