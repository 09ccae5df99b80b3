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
// Design.  One thread owns one (destination row, column).  A block is one
// destination row x kRobustThreads columns; its first thread reads the
// row's dmax weights and indices, keeps the occupied slots in slot order
// in shared memory, and traps on an index outside [0, n).  The 1-D grid
// runs destination rows fastest, as edges_kernel in gossip_mix.cu does,
// so the rows that gather one column tile run together and share it in L2.
// Each thread inserts its occupied values one at a time into a sorted
// array held in registers: the array is sized by the template DPAD (the
// padded slot count, 8 to 64) and every insertion is a fully unrolled
// pass of selects over it, so no index is dynamic and nothing spills to
// local memory (ptxas: 45 registers for the f32 trimmed mean at 16
// slots, 146 at 64, no spills).  Insertion after equal keys is a stable
// sort, and a stable sort's output is unique, so it equals the
// reference's odd-even transposition network; padding slots there sort
// after every real key (2e30 > 1e30), so sorting only the occupied slots
// gives the same first cnt pairs.
//
// What bounds it on the card: its least time is that of gossip_edges's
// bytes (each plane row read once, the output written once: 2 * n * P * b,
// 1.18 ms for the VGG-16 f32 plane at 3.35 TB/s); the compare-exchanges
// the data needs (sum_i k_i (k_i - 1) / 2 per column, k_i = row i's
// occupied slots) come to less.  As written, though, each insertion is a
// pass over all DPAD slots, some 2,500 selects per column at BA(33, 2)
// (157 occupied slots, DPAD = 16), and the block's first thread reads the
// row's table serially, so the kernel runs far above its bound (19.2 ms
// at the VGG-16 f32 plane on an H100 SXM at 700 W).  A parallel table
// read, a sort sized to each row's own degree and a warp-cooperative
// sort are later work.
//
// Bit identity with the plain version (kernels/gossip_mix.py
// gossip_robust_ref).  Sums run in ascending sorted order over the kept
// pairs, multiplies and adds unfused (__fmul_rn / __fadd_rn), and the
// division is IEEE (__fdiv_rn); the library is built without fast math.
// With lowp = 1 on a bf16 plane (mix_in_float32=False) the weight, the
// key, every product, every partial sum and the quotient are rounded to
// bf16 in that same order, as the plain version's bf16 tensors are.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRobustThreads = 256;
constexpr int kMaxSlots = 64;         // the widest instantiation

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

template <typename T, int DPAD, bool LOWP, bool MEDIAN>
__global__ void __launch_bounds__(kRobustThreads)
robust_kernel(const float* __restrict__ w, const int* __restrict__ idx,
              const T* __restrict__ plane, T* __restrict__ out, int n,
              int dmax, long long p, long long ld, int trim_k) {
  __shared__ float ws[DPAD];
  __shared__ int is[DPAD];
  __shared__ int s_cnt;
  const long long bid = blockIdx.x;
  const int i = static_cast<int>(bid % n);
  const long long col = (bid / n) * kRobustThreads + threadIdx.x;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int d = 0; d < dmax; ++d) {
      const long long e = static_cast<long long>(i) * dmax + d;
      const int j = idx[e];
      if (j < 0 || j >= n) __trap();  // a table index outside the plane
      const float wv = LOWP ? bf16_round(w[e]) : w[e];
      if (wv > 0.0f) {
        ws[c] = wv;
        is[c] = j;
        ++c;
      }
    }
    s_cnt = c;
  }
  __syncthreads();
  if (col >= p) return;
  const int cnt = s_cnt;
  // the sanitising bound in the accumulation dtype
  const float big = LOWP ? bf16_round(1e30f) : 1e30f;

  float key[DPAD];
  float wt[DPAD];
#pragma unroll
  for (int j = 0; j < DPAD; ++j) {
    key[j] = 0.0f;
    wt[j] = 0.0f;
  }
  for (int s = 0; s < cnt; ++s) {
    float x = load_one(plane + static_cast<long long>(is[s]) * ld + col);
    x = isnan(x) ? big : fminf(fmaxf(x, -big), big);
    const float wx = ws[s];
    // stable insertion of (x, wx) into key[0..s): positions below the
    // insertion point keep their pair, the point takes (x, wx), the
    // positions above it up to s take their left neighbour's pair
#pragma unroll
    for (int j = DPAD - 1; j >= 0; --j) {
      if (j <= s && !(j < s && key[j] <= x)) {
        const int left = j > 0 ? j - 1 : 0;
        const bool here = j == 0 || key[left] <= x;
        key[j] = here ? x : key[left];
        wt[j] = here ? wx : wt[left];
      }
    }
  }

  const long long o = static_cast<long long>(i) * ld + col;
  const float self = load_one(plane + o);
  float r;
  if (MEDIAN) {
    const int lo = (cnt - 1) / 2;
    const int hi = cnt / 2;
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int j = 0; j < DPAD; ++j) {
      if (j == lo) a = key[j];
      if (j == hi) b = key[j];
    }
    r = cnt > 0 ? mul<LOWP>(0.5f, add<LOWP>(a, b)) : self;
  } else {
    float mass = 0.0f, num = 0.0f;
#pragma unroll
    for (int j = 0; j < DPAD; ++j) {
      if (j >= trim_k && j < cnt - trim_k) {
        mass = add<LOWP>(mass, wt[j]);
        num = add<LOWP>(num, mul<LOWP>(wt[j], key[j]));
      }
    }
    if (mass > 0.0f) {
      r = __fdiv_rn(num, mass);
      if (LOWP) r = bf16_round(r);
    } else {
      r = self;
    }
  }
  store_one(out + o, r);
}

template <typename T, int DPAD, bool LOWP>
void launch_robust(int median, const void* w, const void* idx,
                   const void* plane, void* out, int n, int dmax,
                   long long p, long long ld, int trim_k,
                   cudaStream_t stream) {
  const long long blocks =
      (p + kRobustThreads - 1) / kRobustThreads * static_cast<long long>(n);
  const float* wp = static_cast<const float*>(w);
  const int* ip = static_cast<const int*>(idx);
  const T* pp = static_cast<const T*>(plane);
  T* op = static_cast<T*>(out);
  if (median) {
    robust_kernel<T, DPAD, LOWP, true>
        <<<static_cast<unsigned>(blocks), kRobustThreads, 0, stream>>>(
            wp, ip, pp, op, n, dmax, p, ld, trim_k);
  } else {
    robust_kernel<T, DPAD, LOWP, false>
        <<<static_cast<unsigned>(blocks), kRobustThreads, 0, stream>>>(
            wp, ip, pp, op, n, dmax, p, ld, trim_k);
  }
}

template <typename T, bool LOWP>
void dispatch_width(int median, const void* w, const void* idx,
                    const void* plane, void* out, int n, int dmax,
                    long long p, long long ld, int trim_k,
                    cudaStream_t s) {
  if (dmax <= 8) {
    launch_robust<T, 8, LOWP>(median, w, idx, plane, out, n, dmax, p, ld,
                              trim_k, s);
  } else if (dmax <= 16) {
    launch_robust<T, 16, LOWP>(median, w, idx, plane, out, n, dmax, p, ld,
                               trim_k, s);
  } else if (dmax <= 32) {
    launch_robust<T, 32, LOWP>(median, w, idx, plane, out, n, dmax, p, ld,
                               trim_k, s);
  } else {
    launch_robust<T, kMaxSlots, LOWP>(median, w, idx, plane, out, n, dmax,
                                      p, ld, trim_k, s);
  }
}

}  // namespace

extern "C" int gossip_robust_max_slots() { return kMaxSlots; }

// dtype: 0 = float32, 1 = bfloat16.  lowp: accumulate in the plane dtype.
// median: 1 = median, 0 = trimmed mean dropping trim_k per side.
// ld: row stride of both plane and out, in elements.  dmax must be at
// most gossip_robust_max_slots() (the wrapper checks; wider tables return
// cudaErrorInvalidValue without a launch).
extern "C" int gossip_robust_launch(const void* w, const void* idx,
                                    const void* plane, void* out, int n,
                                    int dmax, long long p, long long ld,
                                    int dtype, int lowp, int median,
                                    int trim_k, void* stream) {
  if (dmax > kMaxSlots || trim_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0 && dmax > 0) {
    if (dtype == 0) {
      dispatch_width<float, false>(median, w, idx, plane, out, n, dmax, p,
                                   ld, trim_k, s);
    } else if (lowp) {
      dispatch_width<__nv_bfloat16, true>(median, w, idx, plane, out, n,
                                          dmax, p, ld, trim_k, s);
    } else {
      dispatch_width<__nv_bfloat16, false>(median, w, idx, plane, out, n,
                                           dmax, p, ld, trim_k, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
