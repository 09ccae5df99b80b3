// The RWKV-6 recurrence for Hopper (sm_90a): the time-mix scan of the
// RWKV-6 family's prefill.
//
// rwkv_kernel replaces the TPU kernel repro/kernels/ssm_scan.py
// rwkv_scan_pallas (body _kernel).  For batch b and head h, with the
// (hd, hd) f32 state S (row i: k's channel, column j: v's channel):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j]);
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j],
// from the initial state s0; it writes y in r's type and the final S in
// f32.  All arithmetic is f32 on the CUDA cores (r, k, v are f32 or bf16;
// w, u and the states are f32).  No TF32.
//
// Not the TPU's chunked form.  The TPU kernel rewrites the scan as
// chunked GEMMs for the MXU: it divides by the in-chunk cumulative
// product of the decays (p / w, k / p), which overflows when decays are
// small, pads S with w = 1, k = 0, and carries S in VMEM scratch across a
// sequential grid axis, which the card does not have.  This kernel runs
// the sequential recurrence: the state's columns are independent (y_t[j]
// needs only column j of S), so the columns of a head split over blocks
// and each block walks the whole sequence in a loop.
//
// Layout.  r, k, v, w are (B, S, H, hd), read in place through their
// strides (the last dimension contiguous, every row 16-byte aligned; the
// wrapper checks): no transposes, no padding.  u is (H, hd) or (B, H, hd)
// (batch stride 0 broadcasts; a fleet folds its node axis into B, each
// node with its own u).  s0 and the final state are contiguous (B, H, hd,
// hd); y is contiguous (B, S, H, hd).
//
// Design.  The grid is (hd / CB, H, B): a block owns CB state columns of
// one (b, h) (CB = 8, 16 or 32, from the launch plan, kernels/ssm_scan.py
// scan_plan, which the entry checks), so the rwkv6-3b prefill (B = 2,
// H = 40, hd = 64) runs hundreds of blocks over the 132 SMs, not 80
// blocks of eight warps on 80 of them.  A thread holds kRows = 8 rows of
// kCols = 2 columns of the state in registers; P = hd / 8 threads share a
// column pair, thread p taking rows 4 * (c * P + p) + e (c < 2, e < 4),
// so that the P threads' float4 reads of a row vector are one 128-byte
// shared-memory wavefront, and each r, k, w value read serves two
// columns.  Per chunk of 16 time steps:
//   * r, k, w and the block's CB columns of v arrive by 16-byte cp.async
//     copies into a ring of 3 stages, two chunks ahead of the arithmetic;
//     steps past S are zero-filled and their decay set to 1, so they
//     leave the state exact and need no branch in the step loop;
//   * a prep pass converts r, k and v to f32 in shared memory and forms
//     the step's bonus a_t = sum_i r_t[i] u[i] k_t[i] (hd / Q rows a
//     thread, then xor shuffles over the step's Q threads), so a column's
//     bonus term is v_t[j] * a_t and the step loop does 3 f32 operations
//     an element (k * v, the y FMA, the state FMA), not 4;
//   * the step loop: each thread updates its 16 elements and keeps its
//     partial y of its two columns; after KT = P / 2 steps a
//     reduce-scatter over the P threads (P / 2 + ... + 1 shuffles) leaves
//     each thread the whole sum of one (step, column), which adds
//     v_t[j] * a_t and goes to a y tile in shared memory; the tile leaves
//     as 16-byte stores of whole rows.
// Two barriers a chunk: one before the prep (the chunk has landed, the
// last chunk's arithmetic is done), one after it.  The 8 x 2 tile is
// among the fastest of the tiles benchmarks/kernel_split.py times (4 or 8
// rows by 1, 2 or 4 columns); a column a thread issues twice the row
// reads a multiply-add.
//
// What bounds it on the card: the sequence.  The work is 4 * hd^2 flops
// per (b, t, h) as the reference counts it: 5.37 GFLOP at the rwkv6-3b
// prefill shape, 0.080 ms at the f32 CUDA-core peak (67 TFLOP/s); its
// bytes (r, k, v, y in bf16, w f32, both states) are about 254 MB, 0.076
// ms at 3.35 TB/s.  But B * H * hd^2 = 327,680 state elements are all the
// parallel work there is, 16 a thread, each walked through 4096 dependent
// steps: the step loop's issue and shared-memory rates (3 FP32
// instructions an element, 6 row-vector reads a step, the
// reduce-scatter's share) and the chunk's two barriers set the time.  The
// measured times and the split between staging and arithmetic are in
// PERF.md section 6.  A chunked form with the decays kept in log space
// (wgmma on the intra-chunk products) is the way past it.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); it refuses an hd other than 32 or 64 and a
// plan that does not fit the operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

namespace {

constexpr int kRows = 8;     // state rows a thread
constexpr int kCols = 2;     // state columns a thread
constexpr int kSteps = 16;   // time steps a chunk
constexpr int kStages = 3;   // ring stages
constexpr int kPlanFields = 4;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  void* y;
  float* sT;
  int S, H;
  // element strides of (batch, seq, head) for r, k, v, w, y; the head
  // dimension is contiguous
  long long rs[3], ks[3], vs[3], ws[3], ys[3];
  long long us[2];  // (batch, head) strides of u; batch stride 0 broadcasts
};

// Block geometry and shared-memory layout of one instantiation: a ring of
// kStages stages [r][k][w][v] of raw inputs, then the f32 work tiles
// [r][k][v][a] of the chunk being computed, then the y tile.
template <typename T, int HD, int CB>
struct Shape {
  static constexpr int P = HD / kRows;          // threads a column
  static constexpr int KT = P / kCols;          // steps a reduce-scatter
  static constexpr int NT = CB / kCols * P;     // threads a block
  static constexpr int Q = NT >= kSteps ? NT / kSteps : 1;  // prep threads
  static constexpr int RPT = HD / Q;            // rows a prep thread
  static constexpr int RK_BYTES = kSteps * HD * static_cast<int>(sizeof(T));
  static constexpr int W_BYTES = kSteps * HD * 4;
  static constexpr int V_BYTES = kSteps * CB * static_cast<int>(sizeof(T));
  static constexpr int STAGE = 2 * RK_BYTES + W_BYTES + V_BYTES;
  static constexpr int WORK = (2 * kSteps * HD + kSteps * CB + kSteps) * 4;
  static constexpr int YTILE = kSteps * CB * 4;
  static constexpr int SMEM = kStages * STAGE + WORK + YTILE;
  static constexpr bool OK = NT % 32 == 0 && NT <= 1024 && Q >= 1 &&
                            Q <= 32 && HD % Q == 0 && RPT % 4 == 0 &&
                            KT >= 1 && kSteps % (KT > 0 ? KT : 1) == 0 &&
                            CB % kCols == 0;

  static_assert(STAGE % 16 == 0 && V_BYTES % 16 == 0, "16-byte copies");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// N consecutive values of shared memory at src (16-byte aligned for f32,
// 8-byte for bf16) as floats
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* src, float (&dst)[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + e);
      dst[e] = x.x;
      dst[e + 1] = x.y;
      dst[e + 2] = x.z;
      dst[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + e);
      dst[e] = bf16_lo(x.x);
      dst[e + 1] = bf16_hi(x.x);
      dst[e + 2] = bf16_lo(x.y);
      dst[e + 3] = bf16_hi(x.y);
    }
  }
}

// 16 bytes of T from 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* x) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&two);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The step sums of P steps, one a register, over the P threads of a
// column (lanes p = 0 .. P - 1 of an aligned group): afterwards lane p
// holds the whole sum of step p.  Each halving keeps the half of the
// steps its bit selects and adds the partner's copy of it.
template <int P>
__device__ __forceinline__ float reduce_scatter(float (&v)[P], int p) {
#pragma unroll
  for (int m = P / 2; m >= 1; m /= 2) {
    const bool upper = (p & m) != 0;
#pragma unroll
    for (int q = 0; q < m; ++q) {
      const float send = upper ? v[q] : v[q + m];
      const float keep = upper ? v[q + m] : v[q];
      v[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0];
}

template <typename T, int HD, int CB>
__global__ void __launch_bounds__(Shape<T, HD, CB>::NT)
rwkv_kernel(const Args a) {
  using Sh = Shape<T, HD, CB>;
  constexpr int P = Sh::P;
  constexpr int KT = Sh::KT;
  constexpr int NT = Sh::NT;
  constexpr int C4 = kRows / 4;   // float4 row pieces a thread
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // values a copy
  extern __shared__ __align__(16) unsigned char smem[];
  float* const rf = reinterpret_cast<float*>(smem + kStages * Sh::STAGE);
  float* const kf = rf + kSteps * HD;
  float* const vf = kf + kSteps * HD;
  float* const af = vf + kSteps * CB;
  float* const yt = af + kSteps;

  const int g = blockIdx.x;     // column group
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int jl = tid / P * kCols;   // the block's first column of this thread
  const int p = tid % P;            // its part of the columns' rows
  const int j = g * CB + jl;
  const int S = a.S;

  const T* rp = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp =
      static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2] + g * CB;
  const float* wp = a.w + b * a.ws[0] + h * a.ws[2];
  T* yp = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[2] + g * CB;
  const long long s_off = (b * a.H + h) * HD * HD;

  float s[kRows][kCols];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        s[4 * c + e][d] = a.s0[s_off + (4 * (c * P + p) + e) * HD + j + d];
      }
    }
  }
  // the prep pass's step and rows, and their bonus
  const int pt = tid / Sh::Q;
  const int prow = (tid % Sh::Q) * Sh::RPT;
  float uu[Sh::RPT];
  {
    const float* up = a.u + b * a.us[0] + h * a.us[1] + prow;
#pragma unroll
    for (int e = 0; e < Sh::RPT; ++e) uu[e] = up[e];
  }

  // the chunk's copies into ring stage `st`; steps past S read nothing
  // and are zero-filled
  auto issue = [&](int chunk, int st) {
    unsigned char* base = smem + st * Sh::STAGE;
    const uint32_t dst = sm90::smem_addr(base);
    const int t0 = chunk * kSteps;
    constexpr int RV = HD / E;          // copies a row of r or k
    constexpr int WV = HD / 4;          // copies a row of w
    constexpr int VV = CB / E;          // copies a row of the v columns
    for (int q = tid; q < 2 * kSteps * RV; q += NT) {
      const int arr = q / (kSteps * RV);
      const int t = (q / RV) % kSteps;
      const int c = q % RV;
      const long long tt = t0 + t;
      const T* src = arr ? kp : rp;
      const long long st_ = arr ? a.ks[1] : a.rs[1];
      const bool in = tt < S;
      sm90::cp_async16(dst + arr * Sh::RK_BYTES + (t * RV + c) * 16,
                       in ? src + tt * st_ + c * E : src, in ? 16 : 0);
    }
    for (int q = tid; q < kSteps * WV; q += NT) {
      const int t = q / WV;
      const int c = q % WV;
      const long long tt = t0 + t;
      const bool in = tt < S;
      sm90::cp_async16(dst + 2 * Sh::RK_BYTES + (t * WV + c) * 16,
                       in ? wp + tt * a.ws[1] + c * 4 : wp, in ? 16 : 0);
    }
    for (int q = tid; q < kSteps * VV; q += NT) {
      const int t = q / VV;
      const int c = q % VV;
      const long long tt = t0 + t;
      const bool in = tt < S;
      sm90::cp_async16(
          dst + 2 * Sh::RK_BYTES + Sh::W_BYTES + (t * VV + c) * 16,
          in ? vp + tt * a.vs[1] + c * E : vp, in ? 16 : 0);
    }
  };

  // r, k, v of ring stage `st` to f32 work tiles, the bonus a_t, and a
  // decay of 1 for the steps past S
  auto prep = [&](int chunk, int st) {
    unsigned char* base = smem + st * Sh::STAGE;
    const T* rr = reinterpret_cast<const T*>(base);
    const T* kr = reinterpret_cast<const T*>(base + Sh::RK_BYTES);
    float* wr = reinterpret_cast<float*>(base + 2 * Sh::RK_BYTES);
    const T* vr =
        reinterpret_cast<const T*>(base + 2 * Sh::RK_BYTES + Sh::W_BYTES);
    float rv[Sh::RPT], kv[Sh::RPT];
    load_f32<T, Sh::RPT>(rr + pt * HD + prow, rv);
    load_f32<T, Sh::RPT>(kr + pt * HD + prow, kv);
    float part = 0.0f;
#pragma unroll
    for (int e = 0; e < Sh::RPT; e += 4) {
      *reinterpret_cast<float4*>(rf + pt * HD + prow + e) =
          make_float4(rv[e], rv[e + 1], rv[e + 2], rv[e + 3]);
      *reinterpret_cast<float4*>(kf + pt * HD + prow + e) =
          make_float4(kv[e], kv[e + 1], kv[e + 2], kv[e + 3]);
    }
#pragma unroll
    for (int e = 0; e < Sh::RPT; ++e) part = fmaf(rv[e] * uu[e], kv[e], part);
#pragma unroll
    for (int m = Sh::Q / 2; m >= 1; m /= 2) {
      part += __shfl_xor_sync(0xffffffffu, part, m);
    }
    if (prow == 0) af[pt] = part;
    if (chunk * kSteps + pt >= S) {
#pragma unroll
      for (int e = 0; e < Sh::RPT; ++e) wr[pt * HD + prow + e] = 1.0f;
    }
    for (int q = tid; q < kSteps * CB; q += NT) {
      vf[q] = to_f32(vr[q]);
    }
  };

  // the y tile of chunk `chunk` to y, whole 16-byte row pieces
  auto write_y = [&](int chunk) {
    constexpr int VV = CB / E;
    for (int q = tid; q < kSteps * VV; q += NT) {
      const int t = q / VV;
      const int c = q % VV;
      const long long tt = static_cast<long long>(chunk) * kSteps + t;
      if (tt < S) {
        *reinterpret_cast<uint4*>(yp + tt * a.ys[1] + c * E) =
            pack16<T>(yt + t * CB + c * E);
      }
    }
  };

  auto compute = [&](int chunk, int st) {
    const float* wr =
        reinterpret_cast<const float*>(smem + st * Sh::STAGE +
                                       2 * Sh::RK_BYTES);
    const int t0 = chunk * kSteps;
#pragma unroll 1
    for (int gq = 0; gq < kSteps; gq += KT) {
      if (t0 + gq >= S) break;   // the same for the whole block
      float part[KT * kCols];     // [step][column] partial sums of y
#pragma unroll
      for (int q = 0; q < KT; ++q) {
        const int t = gq + q;
        const float4* r4 = reinterpret_cast<const float4*>(rf + t * HD);
        const float4* k4 = reinterpret_cast<const float4*>(kf + t * HD);
        const float4* w4 = reinterpret_cast<const float4*>(wr + t * HD);
        float vj[kCols];
#pragma unroll
        for (int d = 0; d < kCols; ++d) vj[d] = vf[t * CB + jl + d];
        float acc[2][kCols];
#pragma unroll
        for (int d = 0; d < kCols; ++d) acc[0][d] = acc[1][d] = 0.0f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 r_ = r4[c * P + p];
          const float4 k_ = k4[c * P + p];
          const float4 w_ = w4[c * P + p];
          const float rv[4] = {r_.x, r_.y, r_.z, r_.w};
          const float kv[4] = {k_.x, k_.y, k_.z, k_.w};
          const float wv[4] = {w_.x, w_.y, w_.z, w_.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int d = 0; d < kCols; ++d) {
              float& se = s[4 * c + e][d];
              acc[c % 2][d] = fmaf(rv[e], se, acc[c % 2][d]);
              se = fmaf(wv[e], se, kv[e] * vj[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < kCols; ++d) {
          part[q * kCols + d] = acc[0][d] + acc[1][d];
        }
      }
      // lane p is left the whole sum of step p / kCols, column p % kCols
      const float sum = reduce_scatter<P>(part, p);
      const int t = gq + p / kCols;
      const int jt = jl + p % kCols;
      yt[t * CB + jt] = fmaf(vf[t * CB + jt], af[t], sum);
    }
  };

  const int n_chunks = (S + kSteps - 1) / kSteps;
#pragma unroll 1
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue(c, c);
    sm90::cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kStages;
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c has landed; chunk c - 1's arithmetic done
    if (c > 0) write_y(c - 1);
    prep(c, st);
    if (c + kStages - 1 < n_chunks) {
      issue(c + kStages - 1, (c + kStages - 1) % kStages);
    }
    sm90::cp_async_commit();
    __syncthreads();   // work tiles ready, the y tile free
    compute(c, st);
  }
  __syncthreads();
  write_y(n_chunks - 1);

#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int d = 0; d < kCols; ++d) {
        a.sT[s_off + (4 * (c * P + p) + e) * HD + j + d] = s[4 * c + e][d];
      }
    }
  }
}

template <typename T, int HD, int CB>
cudaError_t launch_cb(const Args& a, int B, const long long* plan,
                      cudaStream_t stream) {
  using Sh = Shape<T, HD, CB>;
  if constexpr (!Sh::OK) {
    return cudaErrorInvalidValue;   // no such block for this head dim
  } else {
    if (plan[1] != Sh::NT || plan[2] != Sh::SMEM || plan[3] != HD / CB) {
      return cudaErrorInvalidValue;
    }
    auto kernel = rwkv_kernel<T, HD, CB>;
    if (Sh::SMEM > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
      if (err != cudaSuccess) {
        cudaGetLastError();   // returned here; not left for a later launch
        return err;
      }
    }
    kernel<<<dim3(HD / CB, a.H, B), Sh::NT, Sh::SMEM, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const Args& a, int B, const long long* plan,
                      cudaStream_t stream) {
  switch (plan[0]) {
    case 8: return launch_cb<T, HD, 8>(a, B, plan, stream);
    case 16: return launch_cb<T, HD, 16>(a, B, plan, stream);
    case 32: return launch_cb<T, HD, 32>(a, B, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int hd, int B, const long long* plan,
                         cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, B, plan, stream);
    case 64: return launch_hd<T, 64>(a, B, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 17 element strides: (batch, seq, head) for r, k, v, w, y, then
// (batch, head) for u.  dtype of r, k, v and y: 0 = f32, 1 = bf16.  plan:
// kPlanFields int64 values of kernels/ssm_scan.py scan_plan (columns a
// block, threads a block, dynamic shared bytes, column groups), host
// memory.
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const float* w, const float* u,
                                const float* s0, void* y, float* sT,
                                const long long* strides, int dtype, int B,
                                int S, int H, int hd, const long long* plan,
                                cudaStream_t stream) {
  if (S <= 0 || B <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < kPlanFields; ++i) {
    if (plan[i] < 0 || plan[i] > (1LL << 30)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = w;
  a.u = u;
  a.s0 = s0;
  a.y = y;
  a.sT = sT;
  a.S = S;
  a.H = H;
  for (int i = 0; i < 3; ++i) {
    a.rs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.ws[i] = strides[9 + i];
    a.ys[i] = strides[12 + i];
  }
  a.us[0] = strides[15];
  a.us[1] = strides[16];
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(a, hd, B, plan, stream)
      : dtype == 1 ? launch_typed<__nv_bfloat16>(a, hd, B, plan, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
