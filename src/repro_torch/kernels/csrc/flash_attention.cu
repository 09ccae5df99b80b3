// Causal flash attention for Hopper (sm_90a) with GQA, a sliding window
// and a tanh logit softcap (gemma2): the prefill attention of the dense
// transformer stack.
//
// flash_kernel replaces the TPU kernel repro/kernels/flash_attention.py
// flash_attention_pallas (body _kernel).  For batch b, query head h,
// query position s and key position t, with g = H / KV and kv head h / g:
//   l(s, t) = (q[b, s, h] . k[b, t, h / g]) * 1 / sqrt(hd);
//   with a cap c > 0, l = c * tanh(l / c);
//   kept where t < S, t <= s (causal) and t > s - window (window > 0),
//   every other logit set to -1e30;
//   out[b, s, h] = sum_t softmax_t(l) v[b, t, h / g], by the online
//   softmax (m, l, acc), divided at the end by max(l, 1e-30).
// All arithmetic is f32 on the CUDA cores, whatever the input type
// (f32 or bf16; the output takes the input's type).  No TF32.
//
// Layout.  q is (B, S, H, hd) and k, v are (B, S, KV, hd), the JAX
// public layout, read in place through their strides (the last dimension
// contiguous); the TPU wrapper's padding of S to a block multiple and its
// transpose to (B, H, S, hd) are gone: the kernel masks the ragged edge.
//
// Design.  One block owns one (b, h, tile of 64 query rows); 256 threads,
// four to a query row.  Each thread keeps a quarter of its row's q and
// acc in registers (hd / 4 values, in float4 chunks interleaved across
// the four threads so that their shared-memory reads are consecutive),
// and all four keep the row's m and l.  A loop inside the block walks
// the key tiles (the TPU's sequential "arbitrary" kv grid axis): the
// block stages a tile of K and V, converted to f32, in shared memory
// (64 keys, 32 at hd = 128: 16 or 32 KB, static), each thread computes
// its partial dot products for the tile's keys, two xor shuffles sum
// them over the row's four threads, and every thread applies the cap,
// the mask and the online-softmax update to its quarter of acc.  Tiles
// wholly above the diagonal or wholly at or before s - window for every
// row of the block are never visited, so a windowed row never
// accumulates the p = exp(0) = 1 of a fully masked tile that the TPU
// kernel computes and later wipes with alpha = 0.  Rows past S (the
// ragged last tile) see every key below S, stay finite, and are not
// written.  Query tiles are issued heaviest first (the last tile sees
// the most keys).
//
// What bounds it on the card: operations.  The work is 4 * hd flops per
// unmasked (s, t) pair per head (the two dot products), 275 GFLOP for
// the stablelm-1.6b prefill shape (B = 4, S = 4096, H = 32, hd = 64), so
// the f32 CUDA-core peak (67 TFLOP/s) bounds it at 4.1 ms, against
// 0.08 ms for its bytes.  As written each row's exp, cap and mask run on
// all four of its threads and the tiles stage through registers with no
// copy/compute overlap; wgmma on bf16 tiles (the tensor cores, 989
// TFLOP/s) is the way past the f32 bound, in a later kernel.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); it refuses an hd other than 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kParts = 4;                 // threads per query row
constexpr int kThreads = kRows * kParts;  // 256
constexpr float kNeg = -1e30f;            // the reference's mask value

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, H, KV;
  // element strides of (batch, seq, head) for q, k, v, out; the head
  // dimension is contiguous
  long long qs[3], ks[3], vs[3], os[3];
  int causal, window;
  float softcap, scale;
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
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int KEYS = HD == 128 ? 32 : 64;  // keys per staged tile
  constexpr int D = HD / kParts;             // values per thread
  constexpr int C = D / 4;                   // float4 chunks per thread
  __shared__ __align__(16) float ks[KEYS * HD];
  __shared__ __align__(16) float vs[KEYS * HD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int r = tid / kParts;
  const int j = tid % kParts;
  const int q0 = qt * kRows;
  const int s = q0 + r;
  const int S = a.S;

  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  // this thread's dims: chunk c covers 4 * (c * kParts + j) .. + 3
  float q[D], acc[D];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * kParts + j) + e;
      q[4 * c + e] = s < S ? to_f32(qp[s * a.qs[1] + d]) : 0.0f;
      acc[4 * c + e] = 0.0f;
    }
  }
  float m = kNeg, l = 0.0f;

  // the key range any row of this tile can see
  const int t_end = a.causal ? min(S, q0 + kRows) : S;
  const int t_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_end = (t_end + KEYS - 1) / KEYS;

  for (int kt = t_begin / KEYS; kt < kt_end; ++kt) {
    const int t0 = kt * KEYS;
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < KEYS * HD; e += kThreads) {
      const int t = t0 + e / HD;
      const int d = e % HD;
      float kx = 0.0f, vx = 0.0f;
      if (t < S) {
        kx = to_f32(kp[t * a.ks[1] + d]);
        vx = to_f32(vp[t * a.vs[1] + d]);
      }
      ks[e] = kx;
      vs[e] = vx;
    }
    __syncthreads();

    float sc[KEYS];
#pragma unroll
    for (int t = 0; t < KEYS; ++t) {
      const float4* kr = reinterpret_cast<const float4*>(ks + t * HD);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 k4 = kr[c * kParts + j];
        dot = fmaf(q[4 * c], k4.x, dot);
        dot = fmaf(q[4 * c + 1], k4.y, dot);
        dot = fmaf(q[4 * c + 2], k4.z, dot);
        dot = fmaf(q[4 * c + 3], k4.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      float lg = dot * a.scale;
      if (a.softcap > 0.0f) lg = tanhf(lg / a.softcap) * a.softcap;
      const int tt = t0 + t;
      bool ok = tt < S;
      if (a.causal) ok = ok && tt <= s;
      if (a.window > 0) ok = ok && tt > s - a.window;
      sc[t] = ok ? lg : kNeg;
    }
    float mt = kNeg;
#pragma unroll
    for (int t = 0; t < KEYS; ++t) mt = fmaxf(mt, sc[t]);
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int t = 0; t < KEYS; ++t) {
      sc[t] = expf(sc[t] - m_new);
      psum += sc[t];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= alpha;
#pragma unroll
    for (int t = 0; t < KEYS; ++t) {
      const float4* vr = reinterpret_cast<const float4*>(vs + t * HD);
      const float p = sc[t];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 v4 = vr[c * kParts + j];
        acc[4 * c] = fmaf(p, v4.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, v4.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, v4.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, v4.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (s >= S) return;
  const float denom = fmaxf(l, 1e-30f);
  T* op = static_cast<T*>(a.out) + b * a.os[0] + s * a.os[1] + h * a.os[2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      from_f32(op + 4 * (c * kParts + j) + e, acc[4 * c + e] / denom);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int hd, int B, cudaStream_t stream) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.H, B);
  switch (hd) {
    case 32:
      flash_kernel<T, 32><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 64:
      flash_kernel<T, 64><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128:
      flash_kernel<T, 128><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, out.
// dtype: 0 = f32, 1 = bf16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int dtype,
                                      int B, int S, int H, int KV, int hd,
                                      int causal, int window, float softcap,
                                      float scale, cudaStream_t stream) {
  if (S <= 0 || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.S = S;
  a.H = H;
  a.KV = KV;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.causal = causal;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  const cudaError_t err =
      dtype == 0 ? launch_typed<float>(a, hd, B, stream)
      : dtype == 1 ? launch_typed<__nv_bfloat16>(a, hd, B, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
