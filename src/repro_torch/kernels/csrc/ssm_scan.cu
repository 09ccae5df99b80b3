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
// the sequential recurrence, rwkv_scan_ref's own arithmetic: the state's
// columns are independent (y_t[j] needs only column j of S), so a block
// owns one (b, h) and walks the sequence in a loop.
//
// Layout.  r, k, v, w are (B, S, H, hd), read in place through their
// strides (the last dimension contiguous): no transposes, no padding; a
// ragged S needs nothing.  u is (H, hd) or (B, H, hd) (batch stride 0
// broadcasts; a fleet folds its node axis into B, each node with its own
// u).  s0 and the final state are contiguous (B, H, hd, hd); y is written
// through its strides.
//
// Design.  One block per (h, b), 4 * hd threads: four threads per state
// column j, each holding hd / 4 of the column's rows in registers (the
// rows 4 * (c * 4 + p) + e, float4 chunks interleaved across the column's
// four threads so that their shared-memory reads are consecutive).  The
// block stages kSteps = 16 time steps of r, k, w and v, converted to f32,
// in shared memory, double-buffered: the global loads of the next chunk
// are issued into registers before the current chunk's steps run and
// stored after them, so their latency hides behind the FMAs, with one
// __syncthreads per chunk.  Per step a thread forms its partial y over
// its rows (four accumulators) and updates them; two xor shuffles sum y
// over the column's four threads, and the first writes it.
//
// What bounds it on the card: neither bytes nor operations, but the
// sequence.  The work is 4 * hd^2 flops per (b, t, h): 5.37 GFLOP at the
// rwkv6-3b prefill shape (B = 2, S = 4096, H = 40, hd = 64), 0.080 ms at
// the f32 CUDA-core peak (67 TFLOP/s); its bytes (r, k, v, y in bf16, w
// f32, both states) are about 254 MB, 0.076 ms at 3.35 TB/s.  But that
// shape has B * H = 80 blocks, under one wave of 132 SMs, each walking
// 4096 dependent steps of about 90 instructions per warp with two warps
// per scheduler: the loop's issue rate, not the card's peaks, sets the
// time.  A chunked form with the decays kept in log space (wgmma on the
// intra-chunk products) or more sequences per SM is the way past it.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); it refuses an hd other than 32 or 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kParts = 4;   // threads per state column
constexpr int kSteps = 16;  // time steps staged per chunk
constexpr int kArrays = 4;  // staged inputs: r, k, w, v

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD * kParts)
rwkv_kernel(const Args a) {
  constexpr int kThreads = HD * kParts;
  constexpr int D = HD / kParts;  // state rows per thread
  constexpr int C = D / 4;        // float4 chunks per thread
  // each thread stages kLoads values per chunk: its own channel i of
  // time steps tid / HD + 4 * (q % 4) of array q / 4
  constexpr int kLoads = kArrays * kSteps * HD / kThreads;
  static_assert(kLoads == 16, "staging assumes 4 arrays x 4 steps a thread");
  __shared__ __align__(16) float st[2][kArrays][kSteps][HD];

  const int h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / kParts;  // state column
  const int p = tid % kParts;  // part of the column's rows
  const int S = a.S;
  const int li = tid % HD;     // staged channel
  const int lt = tid / HD;     // first staged step (0..3)

  const T* rp = static_cast<const T*>(a.r) + b * a.rs[0] + h * a.rs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const float* wp = a.w + b * a.ws[0] + h * a.ws[2];
  T* yp = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[2];
  const float* up = a.u + b * a.us[0] + h * a.us[1];
  const long long s_off = (b * a.H + h) * HD * HD;

  float s[D], uu[D];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (c * kParts + p) + e;
      s[4 * c + e] = a.s0[s_off + i * HD + j];
      uu[4 * c + e] = up[i];
    }
  }

  float pre[kLoads];
  auto load = [&](int t0) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int arr = q / 4;
      const long long t = t0 + lt + 4 * (q % 4);
      float x = 0.0f;
      if (t < S) {
        if (arr == 0) x = to_f32(rp[t * a.rs[1] + li]);
        if (arr == 1) x = to_f32(kp[t * a.ks[1] + li]);
        if (arr == 2) x = wp[t * a.ws[1] + li];
        if (arr == 3) x = to_f32(vp[t * a.vs[1] + li]);
      }
      pre[q] = x;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      st[buf][q / 4][lt + 4 * (q % 4)][li] = pre[q];
    }
  };

  const int n_chunks = (S + kSteps - 1) / kSteps;
  load(0);
  store(0);
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * kSteps;
    const bool more = ch + 1 < n_chunks;
    if (more) load(t0 + kSteps);
    const int n = min(kSteps, S - t0);
    for (int t = 0; t < n; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(st[buf][0][t]);
      const float4* k4 = reinterpret_cast<const float4*>(st[buf][1][t]);
      const float4* w4 = reinterpret_cast<const float4*>(st[buf][2][t]);
      const float vj = st[buf][3][t][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 rr = r4[c * kParts + p];
        const float4 kk = k4[c * kParts + p];
        const float4 ww = w4[c * kParts + p];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float kv = kv4[e] * vj;
          acc[e] = fmaf(rv[e], fmaf(uu[i], kv, s[i]), acc[e]);
          s[i] = fmaf(wv[e], s[i], kv);
        }
      }
      float yj = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      yj += __shfl_xor_sync(0xffffffffu, yj, 1);
      yj += __shfl_xor_sync(0xffffffffu, yj, 2);
      if (p == 0) from_f32(yp + static_cast<long long>(t0 + t) * a.ys[1] + j, yj);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (c * kParts + p) + e;
      a.sT[s_off + i * HD + j] = s[4 * c + e];
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int hd, int B, cudaStream_t stream) {
  const dim3 grid(a.H, B);
  switch (hd) {
    case 32:
      rwkv_kernel<T, 32><<<grid, 32 * kParts, 0, stream>>>(a);
      break;
    case 64:
      rwkv_kernel<T, 64><<<grid, 64 * kParts, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// strides: 17 element strides: (batch, seq, head) for r, k, v, w, y, then
// (batch, head) for u.  dtype of r, k, v and y: 0 = f32, 1 = bf16.
extern "C" int rwkv_scan_launch(const void* r, const void* k, const void* v,
                                const float* w, const float* u,
                                const float* s0, void* y, float* sT,
                                const long long* strides, int dtype, int B,
                                int S, int H, int hd, cudaStream_t stream) {
  if (S <= 0 || B <= 0 || H <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
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
      dtype == 0 ? launch_typed<float>(a, hd, B, stream)
      : dtype == 1 ? launch_typed<__nv_bfloat16>(a, hd, B, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
