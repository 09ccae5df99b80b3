// Causal flash attention for Hopper (sm_90a) with GQA, a sliding window
// and a tanh logit softcap (gemma2): the prefill attention of the dense
// transformer stack.  Two kernels, chosen by the input type.
//
// Both replace the TPU kernel repro/kernels/flash_attention.py
// flash_attention_pallas (body _kernel).  For batch b, query head h,
// query position s and key position t, with g = H / KV and kv head h / g:
//   l(s, t) = (q[b, s, h] . k[b, t, h / g]) * 1 / sqrt(hd);
//   with a cap c > 0, l = c * tanh(l / c);
//   kept where t < S, t <= s (causal) and t > s - window (window > 0),
//   every other logit set to -1e30;
//   out[b, s, h] = sum_t softmax_t(l) v[b, t, h / g], by the online
//   softmax (m, l, acc), divided at the end by max(l, 1e-30).
// q is (B, S, H, hd) and k, v are (B, S, KV, hd), the JAX public layout,
// read in place through their strides (the last dimension contiguous);
// the TPU wrapper's padding of S to a block multiple and its transpose to
// (B, H, S, hd) are gone: the kernels mask the ragged edge.  Key tiles
// wholly above the diagonal or wholly at or before s - window for every
// row of the block are never visited, so a windowed row never accumulates
// the p = exp(0) = 1 of a fully masked tile that the TPU kernel computes
// and later wipes with alpha = 0.  Rows past S stay finite and are not
// written.  Query tiles are issued heaviest first (the last tile sees the
// most keys).
//
// flash_tc_kernel, bf16 in and out: the tensor cores.  What bounds it:
// bf16 tensor-core operations.  The function needs 4 * hd flops per
// unmasked (s, t) pair per head, 275 GFLOP at the stablelm-1.6b prefill
// shape (B = 4, S = 4096, H = 32, hd = 64): 0.278 ms at 989 TFLOP/s,
// against 0.080 ms for its bytes.  The kernel issues 2 * hd flops for
// Q.K^T and kPieces * 2 * hd for P.V per pair (P is split into bf16
// pieces, below), 1.5x the function's count with two pieces, and it
// visits whole 64 x 64 tiles on the diagonal.  Design:
//   * one block is one warpgroup (128 threads) and owns (b, h, 64 query
//     rows); each thread keeps two rows' m and l and their part of the
//     64 x hd f32 accumulator (hd / 2 registers) in registers;
//   * q and a ring of two stages of k and v tiles (64 keys) stay bf16 in
//     shared memory, staged by 16-byte cp.async copies (keys past S are
//     zero-filled), swizzled as wgmma reads them (sm90_bf16.cuh); tile
//     j + 1 is in flight while tile j is multiplied, and v's copies land
//     while the logits of the same tile are computed;
//   * S = Q.K^T by wgmma m64n64k16 from shared memory (bf16 products are
//     exact, sums in f32), then * 1 / sqrt(hd), the cap with the accurate
//     tanhf, and the mask only on tiles that straddle the diagonal, the
//     window edge or S; p = exp2((l - m) log2(e)); each logit is held by
//     one thread, so the scalar work is done once per logit; row max and
//     row sum take two xor shuffles within a quad;
//   * O += P.V by wgmma m64n(hd)k16 with P from registers (the S
//     fragment's layout is the A operand's) and V from shared memory in
//     the transposed-B form.  The reference multiplies an f32 p; one bf16
//     p would move an output by up to 2^-9 of the |v| it averages, over
//     the card's bf16 gate.  So p = hi + mid (+ lo) with hi = bf16(p),
//     mid = bf16(p - hi): kPieces products, p kept to about 2^-18, and l
//     is summed from the f32 p;
//   * out = acc / max(l, 1e-30), rounded once to bf16.
// hd 96 (phi3-mini-3.8b) is native: q, k and v tiles take two 128-byte
// swizzled column blocks, the second half used (sm90_bf16.cuh), so the
// tiles take hd 128's shared memory; Q.K^T runs 6 k-steps and P.V is
// m64n96k16, so the tensor cores do hd 96's work and no more.
// ptxas (-Xptxas -v, sm_90a, this source): 96 / 126 / 128 / 164
// registers at hd 32 / 64 / 96 / 128, no stack and no spills; dynamic
// shared memory 21 / 41 / 81 / 81 KB (5 tiles and 1 KB of alignment
// slack), so 5 / 4 / 4 / 3 blocks fit on an SM by registers.  On the
// H100 at 700 W the stablelm shape takes 1.76 ms (156 TFLOP/s of the
// function's flops, 6.3x the bound) and phi3-mini's (4, 4096, 32, hd
// 96) 3.50 ms (118 TFLOP/s, 8.4x), PERF.md section 6.
//
// flash_kernel, f32 in and out: the CUDA cores, no TF32.  What bounds it:
// f32 operations, 275 GFLOP at the stablelm shape over the 67 TFLOP/s
// f32 CUDA-core peak, 4.1 ms.  One block owns one (b, h, tile of 64
// query rows); 256 threads, four to a query row.  Each thread keeps a
// quarter of its row's q and acc in registers (hd / 4 values, in float4
// chunks interleaved across the four threads so that their shared-memory
// reads are consecutive), and all four keep the row's m and l.  A loop
// inside the block walks the key tiles (the TPU's sequential "arbitrary"
// kv grid axis): the block stages a tile of K and V in shared memory (64
// keys, 32 at hd 96 and 128: 16, 32, 24 or 32 KB at hd 32, 64, 96, 128,
// static), each thread computes its partial dot products for the tile's
// keys, two xor shuffles sum them
// over the row's four threads, and every thread applies the cap, the mask
// and the online-softmax update to its quarter of acc.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); it refuses an hd other than 32, 64, 96 or
// 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the reference's mask value

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

// ---- f32: the CUDA-core kernel --------------------------------------

constexpr int kRows = 64;                 // query rows per block
constexpr int kParts = 4;                 // threads per query row
constexpr int kThreads = kRows * kParts;  // 256

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  constexpr int KEYS = HD >= 96 ? 32 : 64;  // keys per staged tile
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

  const float* qp =
      static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const float* kp =
      static_cast<const float*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const float* vp =
      static_cast<const float*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  // this thread's dims: chunk c covers 4 * (c * kParts + j) .. + 3
  float q[D], acc[D];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * kParts + j) + e;
      q[4 * c + e] = s < S ? qp[s * a.qs[1] + d] : 0.0f;
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
        kx = kp[t * a.ks[1] + d];
        vx = vp[t * a.vs[1] + d];
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
  float* op =
      static_cast<float*>(a.out) + b * a.os[0] + s * a.os[1] + h * a.os[2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      op[4 * (c * kParts + j) + e] = acc[4 * c + e] / denom;
    }
  }
}


// ---- bf16: the tensor-core kernel -----------------------------------

constexpr int kTcRows = 64;      // query rows per block (one warpgroup)
constexpr int kTcKeys = 64;      // keys per staged tile
constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kPieces = 2;       // bf16 pieces of p in P.V
constexpr int kStages = 2;       // depth of the k/v ring
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

template <int HD>
__host__ __device__ constexpr int tc_tile_bytes() {
  return sm90::tile_bytes<HD, kTcKeys>();
}
// q, the ring of k and v tiles, and the slack to align them to 1024 bytes
template <int HD>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (1 + 2 * kStages) * tc_tile_bytes<HD>() + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const Args a) {
  using namespace sm90;
  static_assert(kTcRows == kTcKeys, "q and k/v tiles share one shape");
  constexpr int TB = tc_tile_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  // q at base; stage st: k at base + (1 + st) TB, v at (1 + kStages + st) TB
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int q0 = qt * kTcRows;
  const int S = a.S;
  // this thread's rows: row0 and row0 + 8; its columns of each 8: col, +1
  const int row0 = q0 + 16 * (tid / 32) + (tid % 32) / 4;
  const int col = 2 * (tid % 4);

  using bf16 = __nv_bfloat16;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ks[0] + kvh * a.ks[2];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vs[0] + kvh * a.vs[2];

  // the key tiles any row of this block can see
  const int t_end = a.causal ? min(S, q0 + kTcRows) : S;
  const int t_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt0 = t_begin / kTcKeys;
  const int n = (t_end + kTcKeys - 1) / kTcKeys - kt0;

  // tile kt0 + i into stage i % kStages: k, then v, one copy group each;
  // past the last tile, two empty groups keep the wait counts uniform
  auto stage = [&](int i) {
    const int st = i % kStages;
    if (i >= n) {
      cp_async_commit();
      cp_async_commit();
      return;
    }
    const int t0 = (kt0 + i) * kTcKeys;
    stage_tile<HD, kTcKeys, kTcThreads>(base + (1 + st) * TB, kp, a.ks[1], t0,
                                        S, tid);
    cp_async_commit();
    stage_tile<HD, kTcKeys, kTcThreads>(base + (1 + kStages + st) * TB, vp,
                                        a.vs[1], t0, S, tid);
    cp_async_commit();
  };
  stage_tile<HD, kTcRows, kTcThreads>(base, qp, a.qs[1], q0, S, tid);
  for (int i = 0; i < kStages - 1; ++i) stage(i);  // q lands with k of 0

  float sc[32];    // this thread's logits, then p, of a 64 x 64 tile
  float o[HD / 2];  // its part of acc
#pragma unroll
  for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) o[r] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const int t0 = (kt0 + i) * kTcKeys;
    stage(i + kStages - 1);
    cp_async_wait<2 * kStages - 1>();  // k of tile i (and q) have landed
    fence_proxy_async();
    __syncthreads();

    const uint32_t k_tile = base + (1 + st) * TB;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      wgmma_ss_m64n64(sc, desc_kmajor<HD, kTcRows>(base, ks),
                      desc_kmajor<HD, kTcKeys>(k_tile, ks), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool masked = t0 + kTcKeys > S ||
                        (a.causal && t0 + kTcKeys - 1 > q0) ||
                        (a.window > 0 && t0 <= q0 + kTcRows - 1 - a.window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int hr = (r / 2) % 2;  // row0 or row0 + 8
      float x = sc[r] * a.scale;
      if (a.softcap > 0.0f) x = tanhf(x / a.softcap) * a.softcap;
      if (masked) {
        const int s = row0 + 8 * hr;
        const int t = t0 + 8 * (r / 4) + col + r % 2;
        bool ok = t < S;
        if (a.causal) ok = ok && t <= s;
        if (a.window > 0) ok = ok && t > s - a.window;
        x = ok ? x : kNeg;
      }
      sc[r] = x;
      mx[hr] = fmaxf(mx[hr], x);
    }
    float alpha[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      alpha[hr] = exp2f((m[hr] - m_new) * kLog2e);
      m[hr] = m_new;
      l[hr] *= alpha[hr];  // this thread's part of l; summed at the end
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int hr = (r / 2) % 2;
      // x - m first: a row whose logits are all masked so far has
      // x = m = -1e30 and must get p = 1, as the reference's exp(0)
      sc[r] = exp2f((sc[r] - m[hr]) * kLog2e);
      l[hr] += sc[r];
    }
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) o[r] *= alpha[(r / 2) % 2];
    // keys 16 kk .. 16 kk + 15 of p as register operands, piece by piece
    uint32_t pa[kPieces][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[kPieces];
        split_bf16<kPieces>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], w);
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) pa[pc][kk][j] = w[pc];
      }
    }

    cp_async_wait<2 * kStages - 2>();  // v of tile i has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t v_tile = base + (1 + kStages + st) * TB;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int pc = 0; pc < kPieces; ++pc) {
        wgmma_rs_tb<HD>(o, pa[pc][kk], desc_nmajor<HD, kTcKeys>(v_tile, kk),
                        1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // stage st is refilled by the next iteration
  }

  bf16* op = static_cast<bf16*>(a.out) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int s = row0 + 8 * hr;
    if (s >= S) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(op + s * a.os[1] + 8 * j + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * hr] / denom,
                                o[4 * j + 2 * hr + 1] / denom);
    }
  }
}

cudaError_t launch_f32(const Args& a, int hd, int B, cudaStream_t stream) {
  const dim3 grid((a.S + kRows - 1) / kRows, a.H, B);
  switch (hd) {
    case 32:
      flash_kernel<32><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 64:
      flash_kernel<64><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 96:
      flash_kernel<96><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 128:
      flash_kernel<128><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc_hd(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kTcRows - 1) / kTcRows, a.H, B);
  flash_tc_kernel<HD><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_tc(const Args& a, int hd, int B, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_tc_hd<32>(a, B, stream);
    case 64:
      return launch_tc_hd<64>(a, B, stream);
    case 96:
      return launch_tc_hd<96>(a, B, stream);
    case 128:
      return launch_tc_hd<128>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v, out.
// dtype: 0 = f32 (flash_kernel), 1 = bf16 (flash_tc_kernel: every base
// 16-byte aligned and every stride but out's a multiple of 8, which the
// caller checks).
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
      dtype == 0 ? launch_f32(a, hd, B, stream)
      : dtype == 1 ? launch_tc(a, hd, B, stream)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
