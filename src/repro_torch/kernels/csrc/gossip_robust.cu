// Robust gossip mix for Hopper (sm_90a): Eq. (2) of the paper with the
// weighted mean replaced by a coordinate-wise trimmed mean or median over
// each destination's neighbour slots (DESIGN.md section 16).
//
// robust_kernel replaces the TPU kernel repro/kernels/gossip_mix.py
// gossip_robust_pallas (body _robust_kernel).  For destination row i and
// plane column t, over the padded-ELL slots d whose weight w[i, d] > 0
// ("occupied"; padding and zero-weight slots take no part):
//   key_d = plane[idx[i, d], t], NaN -> +1e30, then clamped to +-1e30;
//   the (key, weight) pairs sorted stably by key;
//   trimmed: drop trim_k pairs per side, out = sum(w * key) / sum(w)
//            over the rest, or the row's own raw value if that mass is 0;
//   median:  out = 0.5 * (key[(cnt - 1) / 2] + key[cnt / 2]) over the cnt
//            occupied pairs, or the row's own raw value if cnt = 0.
//
// Design.  A block owns a tile of W plane columns (W = 32 to 256, from
// the launch plan, kernels/gossip_mix.py robust_plan, which the entry
// checks) and every destination row of it:
//   * it stages the tile's n plane rows into shared memory once, with
//     16-byte cp.async copies (the wrappers make every row 16-byte
//     aligned; the ragged last tile reads only up to P and zero-fills the
//     rest), so each neighbour value is a shared-memory read and each
//     plane byte crosses HBM once.  The plan picks the widest tile with
//     which two blocks fit an SM; where none fits (n above some 880 rows
//     in f32), the same kernel (STAGED = false) gathers the neighbours
//     from global memory instead;
//   * the tile is cut into units of (destination row, 32 COLS columns),
//     COLS columns a lane (two for the median over tables of at most 16
//     slots, so that a unit's table reads, branches and address
//     arithmetic serve twice the columns; cols_for), and each of the 8
//     warps takes an even run of units, row by row.  When its run reaches
//     a row, the warp reads the row's dmax (weight, index) pairs a lane a
//     slot, traps on an index outside [0, n), and compacts the occupied
//     slots in slot order into its shared table (the ballot of w > 0 and
//     the population count of the lower lanes give each slot its place;
//     a staged table holds the slot's offset in the tile), so the table
//     costs a few instructions a row, not a serial loop while 255 threads
//     wait;
//   * the occupied count cnt is the same across the warp, so the unit
//     dispatches to a compile-time bucket CNT in {4, 8, ..., SLOTS} (SLOTS
//     = 8 to 64, the instantiation for the table width) and every loop
//     stops at cnt: a lane reads all its values first (their latency
//     overlaps), sanitises each in two instructions (fminf with 1e30
//     turns NaN into 1e30, then fmaxf with -1e30), then sorts them in
//     place in registers by stable insertion, slot s moving down past the
//     keys greater than it, which costs cnt (cnt - 1) / 2 compare-select
//     steps, not cnt * SLOTS; padding slots sort after every real key in
//     the reference (2e30 > 1e30), so sorting only the occupied slots
//     gives its first cnt pairs.
//
// What bounds it on the card: its least time is that of its bytes (each
// plane row read once, the output written once: 2 * n * P * b, 1.18 ms
// for the VGG-16 f32 plane at 3.35 TB/s); the compare-selects the data
// needs (sum_i cnt_i (cnt_i - 1) / 2 per column, 439 at BA(33, 2), 5
// instructions each with the weights carried along) come to about 1.2 ms
// of issue at that plane, so the sort and the bytes are of one size; the
// reads, the sanitising and the sums add about as much again.  The
// measured times and their split are in PERF.md section 6.
//
// Bit identity with the plain version (kernels/gossip_mix.py
// gossip_robust_ref).  The insertion is stable, and a stable sort's
// output is unique, so it equals the reference's odd-even transposition
// network.  Sums run in ascending sorted order over the kept pairs,
// multiplies and adds unfused (__fmul_rn / __fadd_rn), and the division is
// IEEE (__fdiv_rn); the library is built without fast math.  With lowp =
// 1 on a bf16 plane (mix_in_float32=False) the weight, the key, every
// product, every partial sum and the quotient are rounded to bf16 in that
// same order, as the plain version's bf16 tensors are.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRobustThreads = 32 * kWarps;
constexpr int kMaxSlots = 64;         // the widest instantiation
constexpr int kPlanFields = 5;

// The launch plan, field for field as kernels/gossip_mix.py
// RobustPlan.c_args passes it: tile columns, whether the tile is staged
// in shared memory, slots of the instantiation, grid, dynamic shared
// bytes.
struct RobustPlan {
  int tile_cols, staged, slots, grid, smem;
};

// columns a lane takes in a unit: two for the median over tables of at
// most 16 slots, so a unit's table reads, branches and address arithmetic
// serve twice the columns; one elsewhere, where the weights the trimmed
// mean sorts along would double the registers and halve the blocks an SM
// holds (benchmarks/kernel_split.py times both)
__host__ __device__ constexpr int cols_for(int slots, bool median) {
  return median && slots <= 16 ? 2 : 1;
}

__host__ __device__ __forceinline__ long long plan_smem(const RobustPlan& pl,
                                                        int n, int itemsize) {
  return (pl.staged ? static_cast<long long>(n) * pl.tile_cols * itemsize
                    : 0) +
         static_cast<long long>(kWarps) * pl.slots * 8;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ float load_one(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *p;
  } else {
    return __bfloat162float(*p);
  }
}

template <typename T>
__device__ __forceinline__ void store_one(T* p, float v) {
  if constexpr (sizeof(T) == 4) {
    *p = v;
  } else {
    *p = __float2bfloat16_rn(v);
  }
}

template <bool LOWP>
__device__ __forceinline__ float add(float a, float b) {
  return LOWP ? bf16_round(__fadd_rn(a, b)) : __fadd_rn(a, b);
}

template <bool LOWP>
__device__ __forceinline__ float mul(float a, float b) {
  return LOWP ? bf16_round(__fmul_rn(a, b)) : __fmul_rn(a, b);
}

// A lane's COLS columns of a unit (c at src + 32 c): the row's cnt
// occupied values (slot s at src[to[s]] in the staged tile, src[to[s] *
// ld] in the plane), sorted with their weights and reduced into r.
template <typename T, int CNT, int COLS, bool LOWP, bool MEDIAN, bool STAGED>
__device__ __forceinline__ void reduce_columns(
    const T* src, long long ld, const float* tw, const int* to, int cnt,
    int trim_k, const bool (&live)[COLS], const float (&self)[COLS],
    float (&r)[COLS]) {
  // the sanitising bound in the accumulation dtype
  const float big = LOWP ? bf16_round(1e30f) : 1e30f;
  float key[COLS][CNT];
  float wt[COLS][CNT];
#pragma unroll
  for (int s = 0; s < CNT; ++s) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      key[c][s] = 0.0f;
      wt[c][s] = 0.0f;
    }
  }
  // every value read first, predicated rather than branched on s < cnt so
  // that the reads issue together; NaN -> +big (fminf keeps the number),
  // then the clamp to +-big
#pragma unroll
  for (int s = 0; s < CNT; ++s) {
    if (s < cnt) {
      const int off = to[s];
      const float ws = tw[s];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float x = 0.0f;
        if (STAGED) {
          x = load_one(src + off + 32 * c);
        } else if (live[c]) {
          x = load_one(src + off * ld + 32 * c);
        }
        key[c][s] = fmaxf(fminf(x, big), -big);
        wt[c][s] = ws;
      }
    }
  }
  // stable insertion in place: slot s moves down past the greater keys
  // of the sorted key[0 .. s)
#pragma unroll
  for (int s = 1; s < CNT; ++s) {
    if (s >= cnt) break;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const float x = key[c][s];
      const float wx = wt[c][s];
      bool gt_above = true;   // key[j] > x for the position above
#pragma unroll
      for (int j = s; j >= 1; --j) {
        const bool gt = key[c][j - 1] > x;
        const float kj = gt ? key[c][j - 1] : (gt_above ? x : key[c][j]);
        const float wj = gt ? wt[c][j - 1] : (gt_above ? wx : wt[c][j]);
        key[c][j] = kj;
        wt[c][j] = wj;
        gt_above = gt;
      }
      key[c][0] = gt_above ? x : key[c][0];
      wt[c][0] = gt_above ? wx : wt[c][0];
    }
  }

  if (MEDIAN) {
    const int lo = (cnt - 1) / 2;
    const int hi = cnt / 2;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int j = 0; j < CNT; ++j) {
        if (j >= cnt) break;
        if (j == lo) a = key[c][j];
        if (j == hi) b = key[c][j];
      }
      r[c] = cnt > 0 ? mul<LOWP>(0.5f, add<LOWP>(a, b)) : self[c];
    }
    return;
  }
  float mass[COLS], num[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) mass[c] = num[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < CNT; ++j) {
    if (j >= cnt - trim_k) break;
    if (j >= trim_k) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        mass[c] = add<LOWP>(mass[c], wt[c][j]);
        num[c] = add<LOWP>(num[c], mul<LOWP>(wt[c][j], key[c][j]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    if (mass[c] > 0.0f) {
      const float q = __fdiv_rn(num[c], mass[c]);
      r[c] = LOWP ? bf16_round(q) : q;
    } else {
      r[c] = self[c];
    }
  }
}

// the smallest bucket CNT >= cnt, from 4 up to SLOTS
template <typename T, int CNT, int SLOTS, int COLS, bool LOWP, bool MEDIAN,
          bool STAGED>
__device__ __forceinline__ void dispatch(
    const T* src, long long ld, const float* tw, const int* to, int cnt,
    int trim_k, const bool (&live)[COLS], const float (&self)[COLS],
    float (&r)[COLS]) {
  if constexpr (CNT < SLOTS) {
    if (cnt > CNT) {
      dispatch<T, 2 * CNT, SLOTS, COLS, LOWP, MEDIAN, STAGED>(
          src, ld, tw, to, cnt, trim_k, live, self, r);
      return;
    }
  }
  reduce_columns<T, CNT, COLS, LOWP, MEDIAN, STAGED>(src, ld, tw, to, cnt,
                                                     trim_k, live, self, r);
}

template <typename T, int SLOTS, bool LOWP, bool MEDIAN, bool STAGED>
__global__ void __launch_bounds__(kRobustThreads)
robust_kernel(const float* __restrict__ w, const int* __restrict__ idx,
              const T* __restrict__ plane, T* __restrict__ out, int n,
              int dmax, long long p, long long ld, int trim_k, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long c0 = static_cast<long long>(blockIdx.x) * width;
  const long long tile_bytes =
      STAGED ? static_cast<long long>(n) * width * sizeof(T) : 0;
  T* const tile = reinterpret_cast<T*>(smem);
  float* const tw =
      reinterpret_cast<float*>(smem + tile_bytes) + warp * SLOTS;
  int* const to = reinterpret_cast<int*>(smem + tile_bytes) +
                  kWarps * SLOTS + warp * SLOTS;

  if constexpr (STAGED) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));   // values a copy
    const int per_row = width / E;
    const uint32_t dst = sm90::smem_addr(tile);
    for (int q = threadIdx.x; q < n * per_row; q += kRobustThreads) {
      const int row = q / per_row;
      const long long col = c0 + static_cast<long long>(q % per_row) * E;
      const long long left = p - col;
      const int bytes = left <= 0 ? 0
                        : left >= E ? 16
                                    : static_cast<int>(left * sizeof(T));
      sm90::cp_async16(dst + q * 16, bytes ? plane + row * ld + col : plane,
                       bytes);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
  }

  // a warp takes a run of units, row by row, and reads a row's table when
  // its run reaches the row
  constexpr int COLS = cols_for(SLOTS, MEDIAN);
  const int groups = width / (32 * COLS);
  const int units = n * groups;
  const int per_warp = (units + kWarps - 1) / kWarps;
  const int u_begin = warp * per_warp;
  const int u_end = min(units, u_begin + per_warp);
  int i = u_begin / groups;
  int g = u_begin - i * groups;
  int row = -1;
  int cnt = 0;
  for (int unit = u_begin; unit < u_end; ++unit) {
    if (i != row) {
      // the row's occupied slots, in slot order, into the warp's table
      __syncwarp();
      cnt = 0;
      for (int d0 = 0; d0 < dmax; d0 += 32) {
        const int d = d0 + lane;
        float wv = 0.0f;
        int j = 0;
        if (d < dmax) {
          const long long e = static_cast<long long>(i) * dmax + d;
          j = idx[e];
          if (j < 0 || j >= n) __trap();  // a table index outside the plane
          wv = LOWP ? bf16_round(w[e]) : w[e];
        }
        const bool occupied = d < dmax && wv > 0.0f;
        const unsigned mask = __ballot_sync(0xffffffffu, occupied);
        if (occupied) {
          const int at = cnt + __popc(mask & ((1u << lane) - 1u));
          tw[at] = wv;
          to[at] = STAGED ? j * width : j;
        }
        cnt += __popc(mask);
      }
      __syncwarp();
      row = i;
    }
    const int cl = g * 32 * COLS + lane;
    bool live[COLS];
    float self[COLS];
    float r[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      live[c] = c0 + cl + 32 * c < p;
      if constexpr (STAGED) {
        self[c] = load_one(tile + i * width + cl + 32 * c);
      } else {
        self[c] =
            live[c] ? load_one(plane + i * ld + c0 + cl + 32 * c) : 0.0f;
      }
    }
    if constexpr (STAGED) {
      dispatch<T, 4, SLOTS, COLS, LOWP, MEDIAN, true>(
          tile + cl, 0, tw, to, cnt, trim_k, live, self, r);
    } else {
      dispatch<T, 4, SLOTS, COLS, LOWP, MEDIAN, false>(
          plane + c0 + cl, ld, tw, to, cnt, trim_k, live, self, r);
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      if (live[c]) store_one(out + i * ld + c0 + cl + 32 * c, r[c]);
    }
    if (++g == groups) {
      g = 0;
      ++i;
    }
  }
}

template <typename T, int SLOTS, bool LOWP, bool MEDIAN, bool STAGED>
cudaError_t launch_robust(const RobustPlan& pl, const void* w,
                          const void* idx, const void* plane, void* out,
                          int n, int dmax, long long p, long long ld,
                          int trim_k, cudaStream_t stream) {
  auto kernel = robust_kernel<T, SLOTS, LOWP, MEDIAN, STAGED>;
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // returned here; not left for a later launch
      return err;
    }
  }
  kernel<<<pl.grid, kRobustThreads, pl.smem, stream>>>(
      static_cast<const float*>(w), static_cast<const int*>(idx),
      static_cast<const T*>(plane), static_cast<T*>(out), n, dmax, p, ld,
      trim_k, pl.tile_cols);
  return cudaGetLastError();
}

template <typename T, int SLOTS, bool LOWP>
cudaError_t launch_rule(const RobustPlan& pl, int median, const void* w,
                        const void* idx, const void* plane, void* out, int n,
                        int dmax, long long p, long long ld, int trim_k,
                        cudaStream_t s) {
  if (median) {
    return pl.staged ? launch_robust<T, SLOTS, LOWP, true, true>(
                           pl, w, idx, plane, out, n, dmax, p, ld, trim_k, s)
                     : launch_robust<T, SLOTS, LOWP, true, false>(
                           pl, w, idx, plane, out, n, dmax, p, ld, trim_k, s);
  }
  return pl.staged ? launch_robust<T, SLOTS, LOWP, false, true>(
                         pl, w, idx, plane, out, n, dmax, p, ld, trim_k, s)
                   : launch_robust<T, SLOTS, LOWP, false, false>(
                         pl, w, idx, plane, out, n, dmax, p, ld, trim_k, s);
}

template <typename T, bool LOWP>
cudaError_t launch_slots(const RobustPlan& pl, int median, const void* w,
                         const void* idx, const void* plane, void* out,
                         int n, int dmax, long long p, long long ld,
                         int trim_k, cudaStream_t s) {
  switch (pl.slots) {
    case 8:
      return launch_rule<T, 8, LOWP>(pl, median, w, idx, plane, out, n,
                                     dmax, p, ld, trim_k, s);
    case 16:
      return launch_rule<T, 16, LOWP>(pl, median, w, idx, plane, out, n,
                                      dmax, p, ld, trim_k, s);
    case 32:
      return launch_rule<T, 32, LOWP>(pl, median, w, idx, plane, out, n,
                                      dmax, p, ld, trim_k, s);
    default:
      return launch_rule<T, kMaxSlots, LOWP>(pl, median, w, idx, plane, out,
                                             n, dmax, p, ld, trim_k, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lowp: accumulate in the plane dtype.
// median: 1 = median, 0 = trimmed mean dropping trim_k per side.
// ld: row stride of both plane and out, in elements; plane, out and
// ld * element size 16-byte aligned (the wrapper checks).  plan:
// kPlanFields int64 values of robust_plan(n, p, dmax, dtype), host memory;
// a plan that does not fit the operands (a table wider than its slots, a
// grid that leaves columns out, other shared bytes) returns
// cudaErrorInvalidValue without a launch.
extern "C" int gossip_robust_launch(const void* w, const void* idx,
                                    const void* plane, void* out, int n,
                                    int dmax, long long p, long long ld,
                                    int dtype, int lowp, int median,
                                    int trim_k, const long long* plan,
                                    void* stream) {
  if (dmax > kMaxSlots || dmax < 0 || trim_k < 0 || plan == nullptr ||
      dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kPlanFields; ++i) {
    if (plan[i] < 0 || plan[i] > (1LL << 31) - 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  RobustPlan pl;
  pl.tile_cols = static_cast<int>(plan[0]);
  pl.staged = static_cast<int>(plan[1]);
  pl.slots = static_cast<int>(plan[2]);
  pl.grid = static_cast<int>(plan[3]);
  pl.smem = static_cast<int>(plan[4]);
  const int itemsize = dtype == 0 ? 4 : 2;
  const bool ok =
      (pl.tile_cols == 32 || pl.tile_cols == 64 || pl.tile_cols == 128 ||
       pl.tile_cols == 256) &&
      pl.tile_cols % (32 * cols_for(pl.slots, median != 0)) == 0 &&
      (pl.staged == 0 || pl.staged == 1) &&
      (pl.slots == 8 || pl.slots == 16 || pl.slots == 32 ||
       pl.slots == kMaxSlots) &&
      dmax <= pl.slots && (pl.slots == 8 || 2 * dmax > pl.slots) &&
      pl.grid == (p + pl.tile_cols - 1) / pl.tile_cols &&
      pl.smem == plan_smem(pl, n, itemsize) && pl.smem <= 232448;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0) {
    if (dtype == 0) {
      return static_cast<int>(launch_slots<float, false>(
          pl, median, w, idx, plane, out, n, dmax, p, ld, trim_k, s));
    }
    return static_cast<int>(
        lowp ? launch_slots<__nv_bfloat16, true>(pl, median, w, idx, plane,
                                                 out, n, dmax, p, ld, trim_k,
                                                 s)
             : launch_slots<__nv_bfloat16, false>(pl, median, w, idx, plane,
                                                  out, n, dmax, p, ld, trim_k,
                                                  s));
  }
  return static_cast<int>(cudaGetLastError());
}
