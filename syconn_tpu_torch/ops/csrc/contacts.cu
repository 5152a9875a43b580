// Contact-site window majority vote for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_detect_cs_pallas`
// (syconn_tpu/ops/contacts_pallas.py:46): for every voxel of an (x, y) tile
// column, over the full z extent, the candidate label that is most frequent
// in the (sx, sy, sz) window around the voxel wins. The voxel's own label, 0
// and INT_MAX never count; ties go to the candidate visited first (the
// lower slot of the table). Output is lo = min(center, best), hi =
// max(center, best) where the best count is positive, else 0. All
// arithmetic is integer: the result equals the plain PyTorch version bit for
// bit.
//
// What bounds it on this card: bytes. The function reads the int32 label
// volume once and writes two int32 volumes; the counting stays on chip. The
// first design (one candidate per pass, 13-term box sums re-read from shared
// memory, a linear slot search) spent ~26x the bytes' time in shared-memory
// loads and barriers per candidate. This one:
//
//   * one block of 256 threads per (column, slab of ZS = 12 output planes);
//     the slab's label window (tile + stencil halo) is loaded by warps that
//     each take a run of consecutive (x, y) rows, lanes along z (the
//     contiguous axis), eight rows in flight, and stored as ONE BYTE per
//     voxel: the label's slot in the column's table, found by a binary
//     search when the table is ascending (checked once per block; else a
//     linear search), with the lane's previous label (its y neighbour) as a
//     cache. Two bytes past the table mark label 0 and a label that is no
//     candidate, so the vote's own label needs no second read;
//   * packed counters: the four slots of a group advance in one 32-bit word
//     of byte lanes (one lane a slot); groups that no voxel of the window
//     carries are skipped. Per group and chunk of P = 4 output planes three
//     running sums, each adding the entering plane and subtracting the
//     leaving one: along z per window pencil (<= sz a lane), along x per row
//     (<= sz * sx, still a byte), then along y in two words of 16-bit lanes
//     (even and odd slots; <= sx * sy * sz);
//   * the best update is packed too: per lane a 16-bit key
//     (count << 5) | (31 - slot), the voxel's own slot masked to 0, and a
//     per-lane max (__vmaxu2) into one shared-memory word per voxel (in
//     registers the unrolled tile column spilled) that keeps the best even
//     and the best odd slot. The larger lane at the end is the
//     strict-`>` update in table order (ties to the lower slot), because the
//     slot is in the key. Lane widths: K <= 32, sz * sx <= 255 and
//     sx * sy * sz <= 2047 (mirrored by ops/contacts_cuda.py);
//   * order of operations per block: window load and slot lookup | barrier;
//     per chunk, per present group: z pass | barrier | x pass | barrier |
//     y pass and best update (the next group's z pass writes another buffer
//     and follows without a barrier); then the chunk's lo/hi stores. Two
//     barriers per group and chunk, none per candidate.
//
// -DCONTACTS_TIMING keeps clock counts per stage (thread 0 of every block,
// summed) in a device array (syconn_tpu_torch/tools/contacts_breakdown.py).
//
// Nothing of the TPU layout is carried over: no 128-lane z padding, no
// sublane rounding of the window, no banded matmul for the z sum.

#include <cuda_runtime.h>
#include <cstdint>
#ifdef CONTACTS_TIMING
// summed over blocks, thread 0's clocks: total, window + slots, z, x, y + best,
// stores; then blocks, group passes; then thread 0's load issue and lookup
// clocks and its slot searches (label-cache misses)
__device__ unsigned long long g_dbg[11];
#define TICK(v) long long v = clock64()
#define TOCK(i, v) if (threadIdx.x == 0) atomicAdd(&g_dbg[i], (unsigned long long)(clock64() - v))
#define COUNT(i) if (threadIdx.x == 0) atomicAdd(&g_dbg[i], 1ull)
#else
#define TICK(v)
#define TOCK(i, v)
#define COUNT(i)
#endif

namespace {

constexpr int ZS = 12;              // output planes per block
constexpr int P = 4;                // output planes per chunk
constexpr int NTHREADS = 256;       // one y-pass task (plane, x, half of y) each
constexpr int NWARPS = NTHREADS / 32;
constexpr int LOADS = 8;            // window loads in flight per lane
constexpr int MAX_K = 32;           // slots in a 16-bit key: (count << 5) | (31 - slot)
constexpr int MAX_TILE = 32;        // tx, ty
constexpr int MAX_COUNT = 2047;     // sx * sy * sz: count << 5 fits 16 bits
constexpr int MAX_BYTE = 255;       // sz * sx: the x pass's byte lanes
constexpr int MAX_SMEM = 232448;
constexpr int LABEL_PAD = 0x7fffffff;
// slot bytes past the table: a label that is not a candidate, and label 0 (or
// outside the volume); entries 32 and 33 of the per-group tables are zero
constexpr int NO_SLOT = MAX_K, ZERO_SLOT = MAX_K + 1;
constexpr int NT = MAX_K + 2;       // table row length
static_assert(ZS % P == 0 && P * MAX_TILE * 2 == NTHREADS, "a y-pass task per thread");

struct Dims {
  int Xp, Yp, Z, K, tx, ty, sx, sy, sz;
  int WX, WY, WZ, WYP;  // window extents; odd y pitch of the word buffers
};

// Shared-memory map: candidates, per-group tables, flags, slots, z sums, x sums,
// best keys.
struct Smem {
  int cand, ind, me, mo, flags, slots, zb, xb, best, total;
};
__host__ __device__ inline Smem smem_map(const Dims& d) {
  Smem s{};
  s.cand = 0;
  s.ind = s.cand + MAX_K * 4;
  s.me = s.ind + (MAX_K / 4) * NT * 4;
  s.mo = s.me + (MAX_K / 4) * NT * 4;
  s.flags = s.mo + (MAX_K / 4) * NT * 4;
  s.slots = s.flags + 16;
  s.zb = s.slots + (d.WX * d.WY * d.WZ + 15) / 16 * 16;
  s.xb = s.zb + P * d.WX * d.WYP * 4;
  s.best = s.xb + P * (d.tx * d.WYP + 8) * 4;
  s.total = s.best + d.ty * d.tx * P * 4;
  return s;
}

__global__ void __launch_bounds__(NTHREADS, 2)  // two blocks an SM (~101 KB each)
detect_cs_columns_kernel(const int* __restrict__ seg, const int* __restrict__ offs,
                         const int* __restrict__ cands, int* __restrict__ out_lo,
                         int* __restrict__ out_hi, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  TICK(t_all);
  TICK(t0);
  const Smem S = smem_map(d);
  int* s_cand = reinterpret_cast<int*>(smem + S.cand);
  uint32_t* s_ind = reinterpret_cast<uint32_t*>(smem + S.ind);  // [group][slot]: its lane's 1
  uint32_t* s_me = reinterpret_cast<uint32_t*>(smem + S.me);    // [group][own slot]: masks
  uint32_t* s_mo = reinterpret_cast<uint32_t*>(smem + S.mo);
  int* s_flags = reinterpret_cast<int*>(smem + S.flags);        // present groups; unsorted
  unsigned char* sl = smem + S.slots;                           // [xw][yw][zw]
  uint32_t* zb = reinterpret_cast<uint32_t*>(smem + S.zb);      // [p][xw][yw], pitch WYP
  uint32_t* xb = reinterpret_cast<uint32_t*>(smem + S.xb);      // [p][xo][yw], plane XPL
  uint32_t* bk = reinterpret_cast<uint32_t*>(smem + S.best);    // [yo][xo][p]: best keys
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int z0 = blockIdx.x * ZS;
  const int K = d.K, tx = d.tx, ty = d.ty, sx = d.sx, sy = d.sy, sz = d.sz;
  const int WX = d.WX, WY = d.WY, WZ = d.WZ, WYP = d.WYP;
  const int hx = sx / 2, hy = sy / 2, hz = sz / 2;
  const int XPL = tx * WYP + 8;  // planes of the x sums start on other banks

  if (tid < MAX_K) s_cand[tid] = tid < K ? cands[(int64_t)g * K + tid] : LABEL_PAD;
  if (tid < 2) s_flags[tid] = 0;
  // per group: a slot's byte lane, and the masks that drop the voxel's own slot
  // from the even (slots 4gr, 4gr + 2) and the odd (4gr + 1, 4gr + 3) key word
  for (int i = tid; i < (MAX_K / 4) * NT; i += NTHREADS) {
    const int gr = i / NT, sv = i % NT;
    const bool in = sv < MAX_K && (sv >> 2) == gr;  // false for NO_SLOT, ZERO_SLOT
    s_ind[i] = in ? 1u << ((sv & 3) * 8) : 0u;
    const uint32_t kill = in ? 0xFFFFu << ((sv & 2) * 8) : 0u;
    s_me[i] = (sv & 1) ? ~0u : ~kill;
    s_mo[i] = (sv & 1) ? ~kill : ~0u;
  }
  __syncthreads();
  if (tid < 32) {  // one warp: is the table ascending (padding included)?
    const bool bad = tid + 1 < K && s_cand[tid] > s_cand[tid + 1];
    if (__any_sync(0xffffffffu, bad) && tid == 0) s_flags[1] = 1;
  }
  __syncthreads();

  // label window -> slots (ZERO_SLOT: label 0, or outside the volume)
  const int ox = offs[2 * g], oy = offs[2 * g + 1];
  const bool sorted = s_flags[1] == 0;
  // a warp takes a run of consecutive window rows (x, y), its lanes along z: the
  // loads are coalesced, and a lane's previous label (its y neighbour) caches
  // the lookup
  unsigned int present = 0;
  const int lane = tid & 31, warp = tid >> 5;
  const int nrows = WX * WY, run = (nrows + NWARPS - 1) / NWARPS;
  const int r0 = warp * run, r1 = min(nrows, r0 + run);
  for (int zb = 0; zb < WZ; zb += 32) {
    const int zw = zb + lane, z = z0 - hz + zw;
    const bool zin = zw < WZ, zok = zin && z >= 0 && z < d.Z;
    int last_label = 0, last_slot = ZERO_SLOT;
    int xw = r0 / WY, yw = r0 - (r0 / WY) * WY;
    for (int rb = r0; rb < r1; rb += LOADS) {
      // LOADS independent loads in flight per lane before the first is used
      int labels[LOADS];
      TICK(t_issue);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int x = ox + xw, y = oy + yw;
        labels[u] = rb + u < r1 && zok && x >= 0 && x < d.Xp && y >= 0 && y < d.Yp
                        ? __ldg(seg + ((int64_t)x * d.Yp + y) * d.Z + z)
                        : 0;
        if (++yw == WY) { yw = 0; ++xw; }
      }
      TOCK(8, t_issue);
      TICK(t_use);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (rb + u >= r1) break;
        const int label = labels[u];
        if (label != last_label) {
          COUNT(10);
          int slot = label == 0 ? ZERO_SLOT : NO_SLOT;
          if (label != 0 && label != LABEL_PAD) {
            if (sorted) {  // lower bound: the first slot holding the label
              int lo = 0, hi = K;
              while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (s_cand[mid] < label) lo = mid + 1; else hi = mid;
              }
              if (lo < K && s_cand[lo] == label) slot = lo;
            } else {
              for (int k = 0; k < K; ++k)
                if (s_cand[k] == label) { slot = k; break; }
            }
          }
          last_label = label;
          last_slot = slot;
        }
        if (zin) sl[(rb + u) * WZ + zw] = (unsigned char)last_slot;
        if (last_slot < MAX_K) present |= 1u << (last_slot >> 2);
      }
      TOCK(9, t_use);
    }
  }
  present = __reduce_or_sync(0xffffffffu, present);
  if ((tid & 31) == 0 && present) atomicOr(&s_flags[0], (int)present);
  __syncthreads();
  TOCK(1, t0);
  const unsigned int groups = (unsigned int)s_flags[0];

  // this thread's y-pass task: plane p (fastest, so that a store instruction
  // writes runs of P consecutive z), column xo, half of the tile's y
  const int yh = (ty + 1) / 2, xh = (tx + 1) / 2;
  const bool ytask = tid < P * tx * 2;
  const int tp = tid % P, txo = (tid / P) % tx, th = tid / (P * tx);
  const int ys = th * yh, ye = min(ty, ys + yh);

  // a y-pass thread's best keys: yo steps of tx * P words
  uint32_t* best = bk + txo * P + tp;
  const int bstep = tx * P;
  for (int cz = 0; cz < ZS && z0 + cz < d.Z; cz += P) {
    if (ytask)
      for (int yo = ys; yo < ye; ++yo) best[yo * bstep] = 0u;

    for (int gr = 0; gr < MAX_K / 4; ++gr) {
      if (!((groups >> gr) & 1u)) continue;  // uniform per block
      COUNT(7);
      const uint32_t* ind = s_ind + gr * NT;
      // z pass: per window pencil a running sum over sz planes -> zb[p]
      TICK(t1);
      for (int pc = tid; pc < WX * WY; pc += NTHREADS) {
        const unsigned char* col = sl + pc * WZ + cz;  // window plane cz + k
        uint32_t run = 0;
        for (int k = 0; k < sz - 1; ++k) run += ind[col[k]];
        const int xw = pc / WY, yw = pc - xw * WY;
        uint32_t* dst = zb + xw * WYP + yw;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          run += ind[col[p + sz - 1]];
          dst[p * WX * WYP] = run;
          run -= ind[col[p]];
        }
      }
      __syncthreads();
      TOCK(2, t1);
      // x pass: per (plane, window row, half of the tile's x) a running sum
      // over sx columns -> xb[p][xo][yw]
      TICK(t2);
      for (int t = tid; t < P * WY * 2; t += NTHREADS) {
        const int yw = t % WY, p = (t / WY) % P, half = t / (WY * P);
        const int xs = half * xh, xe = min(tx, xs + xh);
        const uint32_t* src = zb + p * WX * WYP + yw;
        uint32_t* dst = xb + p * XPL + yw;
        uint32_t run = 0;
        for (int k = 0; k < sx - 1; ++k) run += src[(xs + k) * WYP];
        for (int xo = xs; xo < xe; ++xo) {
          run += src[(xo + sx - 1) * WYP];
          dst[xo * WYP] = run;
          run -= src[xo * WYP];
        }
      }
      __syncthreads();
      TOCK(3, t2);
      // y pass in 16-bit lanes (even and odd slots) and the best update
      TICK(t3);
      if (ytask) {
        const uint32_t* src = xb + tp * XPL + txo * WYP;
        const unsigned char* ctr = sl + ((txo + hx) * WY + hy) * WZ + cz + tp + hz;
        const uint32_t tag_e = (31u - 4 * gr) | ((29u - 4 * gr) << 16);
        const uint32_t tag_o = (30u - 4 * gr) | ((28u - 4 * gr) << 16);
        const uint32_t* me = s_me + gr * NT;
        const uint32_t* mo = s_mo + gr * NT;
        uint32_t re = 0, ro = 0;
        for (int k = 0; k < sy - 1; ++k) {
          const uint32_t v = src[ys + k];
          re += v & 0x00FF00FFu;
          ro += (v >> 8) & 0x00FF00FFu;
        }
        for (int yo = ys; yo < ye; ++yo) {
          const uint32_t vin = src[yo + sy - 1];
          re += vin & 0x00FF00FFu;
          ro += (vin >> 8) & 0x00FF00FFu;
          const int cs = ctr[yo * WZ];
          const uint32_t ke = ((re << 5) | tag_e) & me[cs];
          const uint32_t ko = ((ro << 5) | tag_o) & mo[cs];
          best[yo * bstep] = __vmaxu2(best[yo * bstep], __vmaxu2(ke, ko));
          const uint32_t vout = src[yo];
          re -= vout & 0x00FF00FFu;
          ro -= (vout >> 8) & 0x00FF00FFu;
        }
      }
      TOCK(4, t3);
    }

    // the chunk's lo/hi: the larger lane of a voxel's word is its best key
    TICK(t4);
    const int zo = z0 + cz + tp;
    if (ytask && zo < d.Z) {
      const unsigned char* ctr = sl + ((txo + hx) * WY + hy) * WZ + cz + tp + hz;
      for (int yo = ys; yo < ye; ++yo) {
        const uint32_t b = best[yo * bstep];
        const uint32_t m = max(b & 0xFFFFu, b >> 16);
        int lo = 0, hi = 0;
        if ((m >> 5) > 0u) {
          // the voxel's own label: its slot's, 0, or (not a candidate) from memory
          const int cs = ctr[yo * WZ];
          const int center =
              cs < MAX_K ? s_cand[cs]
              : cs == ZERO_SLOT
                  ? 0
                  : __ldg(seg + ((int64_t)(ox + txo + hx) * d.Yp + oy + yo + hy) * d.Z + zo);
          const int id = s_cand[31 - (int)(m & 31u)];
          lo = center < id ? center : id;
          hi = center < id ? id : center;
        }
        const int64_t o = (((int64_t)g * tx + txo) * ty + yo) * d.Z + zo;
        out_lo[o] = lo;
        out_hi[o] = hi;
      }
    }
    TOCK(5, t4);
  }
  TOCK(0, t_all);
  COUNT(6);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t as int (0 = launched). Limits
// (stated in ops/contacts_cuda.py): K <= 32, tx, ty <= 32, sz * sx <= 255,
// sx * sy * sz <= 2047, and the window within shared memory.
int detect_cs_columns_launch(const void* seg, const void* offs, const void* cands,
                             void* out_lo, void* out_hi, int Xp, int Yp, int Z, int G,
                             int K, int tx, int ty, int sx, int sy, int sz, void* stream) {
  if (G < 1 || Z < 1 || K < 1 || K > MAX_K || tx < 1 || ty < 1 || tx > MAX_TILE ||
      ty > MAX_TILE || sx < 1 || sy < 1 || sz < 1 || sz * sx > MAX_BYTE ||
      sx * sy * sz > MAX_COUNT || G > 65535)
    return (int)cudaErrorInvalidValue;
  Dims d;
  d.Xp = Xp; d.Yp = Yp; d.Z = Z; d.K = K;
  d.tx = tx; d.ty = ty; d.sx = sx; d.sy = sy; d.sz = sz;
  d.WX = tx + sx - 1; d.WY = ty + sy - 1; d.WZ = ZS + sz - 1;
  d.WYP = d.WY | 1;
  const int smem = smem_map(d).total;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(detect_cs_columns_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Z + ZS - 1) / ZS, G);
  detect_cs_columns_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const int*)seg, (const int*)offs, (const int*)cands, (int*)out_lo, (int*)out_hi, d);
  return (int)cudaGetLastError();
}

const char* contacts_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

#ifdef CONTACTS_TIMING
const char* contacts_debug_names() {
  return "total,load,z,x,y_best,store,n_blocks,n_group_passes,load_issue,load_use,n_searches";
}
int contacts_debug_reset() {
  unsigned long long z[11] = {};
  return (int)cudaMemcpyToSymbol(g_dbg, z, sizeof(z));
}
int contacts_debug_read(unsigned long long* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_dbg, sizeof(unsigned long long) * 11);
}
#endif

}  // extern "C"
