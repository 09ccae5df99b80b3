// Causal latent-space flash attention for Hopper (sm_90a): the prefill
// attention of MLA (multi-head latent attention, deepseek-v2).
//
// mla_kernel replaces the TPU kernel repro/kernels/mla_attention.py
// mla_attention_pallas (body _kernel).  For sequence b, head h, query
// position s and latent row t (K and V are the same latent c_kv; k_rope
// is shared by all heads):
//   l(s, t) = q_lat[b, s, h] . c_kv[b, t] + q_rope[b, s, h] . k_rope[b, t]
//   (the caller pre-scales q by 1 / sqrt(dn + dr));
//   kept where t < T and t <= s, every other logit set to -1e30;
//   out[b, s, h] = sum_t softmax_t(l) c_kv[b, t], by the online softmax
//   (m, l, acc), divided at the end by max(l, 1e-30).
// The TPU kernel masks t < S instead of t < T, and lets the zero rows it
// pads the latent with into the softmax when T < S and T is not a block
// multiple; this kernel reads only the T real rows, as the plain
// mla_attention_ref does.  The two agree whenever T = S, the prefill.
// All arithmetic is f32 on the CUDA cores, whatever the input types
// (c_kv / k_rope f32 or bf16; q_lat / q_rope / out f32 or the latent's
// type).  No TF32.
//
// Layout.  q_lat (B, S, H, r), q_rope (B, S, H, dr), c_kv (B, T, r),
// k_rope (B, T, dr) and out (B, S, H, r) are read and written in place
// through their strides (the last dimension contiguous, every latent row
// on a 16-byte boundary); the TPU wrapper's padding and its transpose to
// (B, H, S, .) are gone: the kernel masks the ragged edges.
//
// Design.  One block owns one (b, h, tile of ROWS query rows), P threads
// to a row.  The row's W = r + dr query values [q_lat || q_rope] sit in
// registers, W / P per thread, in float4 chunks interleaved across the
// row's P threads so that their shared-memory reads are consecutive; so
// does the row's r-wide accumulator, r / P per thread, and all P threads
// keep the row's m and l.  A loop inside the block walks the latent
// tiles (the TPU's sequential kv grid axis): the block stages KEYS rows
// of [c_kv || k_rope], converted to f32, in shared memory ONCE (16-byte
// loads, all of a thread's in flight together), and that one tile serves
// both products: the logits against
// all W columns and p . c_kv against the first r.  That shared tile is
// the point of MLA: no per-head K or V exists.  The tile's keys go in
// groups of G = 4: each thread forms its partial dot products for the
// group (four independent FMA chains), xor shuffles sum them over the
// row's P threads, and every thread applies the mask and the
// online-softmax update to its part of acc.  Tiles wholly above the
// diagonal of every row of the block are never visited; the first tile
// holds t = 0, which every row sees, so m is finite after it.  Rows past
// S (the ragged last tile) stay finite and are not written.  Query tiles
// are issued heaviest first.
//
// Shared memory and registers set the tile sizes.  One f32 row of
// W = 576 (r 512, dr 64) is 2.3 KB: a 64-row query tile alone would take
// 147 KB of the 227 KB a block may have, so q and acc live in registers.
// At r = 512: 16 query rows of P = 16 threads (256 threads; 36 q and 32
// acc values a thread, 255 registers, no spill: eight keys a group or
// eight threads a row spill), KEYS = 64 latent rows staged (147.5 KB of
// dynamic shared memory; one block a streaming multiprocessor, which the
// registers force anyway).  At r = 32: 32 rows of P = 4 (dr 16) or 64
// rows of P = 2 (dr 8), 128 threads, 64 latent rows (12 / 10 KB).
//
// What bounds it on the card: operations.  2 * (2r + dr) flops per
// unmasked (s, t) pair per head, 9.35 TFLOP for deepseek-v2's prefill
// of 4 x 4096 tokens (H = 128), so the f32 CUDA-core peak (67 TFLOP/s)
// bounds it at 139.5 ms, against 2.7 ms for its bytes.  As written, a
// float4 read from shared memory feeds four FMAs on each of the two rows
// a warp holds, so shared memory (two wavefronts a read) limits it
// before the FMA pipes do, and the staging is not overlapped with the
// FMAs (8 warps a multiprocessor).  Past that: several heads per block
// (all heads read the same c_kv), wgmma on split-bf16 tiles, TMA staging.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(); it refuses an (r, dr) or a type pair it
// has no instantiation for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int G = 4;             // keys per online-softmax update
constexpr float kNeg = -1e30f;  // the reference's mask value

struct Args {
  const void* q_lat;
  const void* q_rope;
  const void* c_kv;
  const void* k_rope;
  void* out;
  int S, T, H;
  // element strides: (batch, seq, head) of q_lat, q_rope and out,
  // (batch, seq) of c_kv and k_rope; the last dimension is contiguous
  long long qls[3], qrs[3], os[3], cks[2], krs[2];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TQ, typename TKV, int R, int DR, int P, int ROWS,
          int KEYS>
__global__ void __launch_bounds__(ROWS * P, 1)
mla_kernel(const Args a) {
  constexpr int THREADS = ROWS * P;
  constexpr int W = R + DR;             // a staged row: [c_kv || k_rope]
  constexpr int CW = W / (4 * P);       // float4 chunks of q per thread
  constexpr int CR = R / (4 * P);       // float4 chunks of acc per thread
  static_assert(W % (4 * P) == 0 && R % (4 * P) == 0, "bad split");
  constexpr int LOG2P = P == 16 ? 4 : P == 8 ? 3 : P == 4 ? 2 : P == 2 ? 1 : 0;
  static_assert((1 << LOG2P) == P && KEYS % G == 0, "bad tile");
  constexpr int V = 16 / sizeof(TKV);   // latent elements per 16-byte load
  static_assert(R % V == 0 && DR % V == 0, "a load crosses c_kv/k_rope");
  constexpr int PER = (KEYS * W / V + THREADS - 1) / THREADS;  // loads/tile
  extern __shared__ __align__(16) float kv[];   // KEYS * W

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / P;
  const int j = tid % P;
  const int q0 = qt * ROWS;
  const int s = q0 + row;
  const int S = a.S, T = a.T;

  const TQ* qlp = static_cast<const TQ*>(a.q_lat) + b * a.qls[0] +
                  h * a.qls[2];
  const TQ* qrp = static_cast<const TQ*>(a.q_rope) + b * a.qrs[0] +
                  h * a.qrs[2];
  const TKV* ckp = static_cast<const TKV*>(a.c_kv) + b * a.cks[0];
  const TKV* krp = static_cast<const TKV*>(a.k_rope) + b * a.krs[0];

  // this thread's columns: chunk c covers 4 * (c * P + j) .. + 3; the
  // first CR chunks are latent columns (< R), the rest rope columns
  float q[4 * CW], acc[4 * CR];
#pragma unroll
  for (int c = 0; c < CW; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (c * P + j) + e;
      float x = 0.0f;
      if (s < S) {
        x = c < CR ? to_f32(qlp[s * a.qls[1] + d])
                   : to_f32(qrp[s * a.qrs[1] + (d - R)]);
      }
      q[4 * c + e] = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * CR; ++i) acc[i] = 0.0f;
  float m = kNeg, l = 0.0f;

  // the latent rows any row of this tile can see: t < T and t <= s
  const int t_end = min(T, q0 + ROWS);
  const int kt_end = (t_end + KEYS - 1) / KEYS;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int t0 = kt * KEYS;
    __syncthreads();  // the previous tile has been consumed
    // 16-byte loads, all of a thread's issued before the first store
    uint4 raw[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = (k * THREADS + tid) * V;
      const int t = t0 + i / W;
      const int d = i % W;
      raw[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < KEYS * W && t < T) {
        raw[k] = *reinterpret_cast<const uint4*>(
            d < R ? ckp + t * a.cks[1] + d : krp + t * a.krs[1] + (d - R));
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = (k * THREADS + tid) * V;
      if (i < KEYS * W) {
        const TKV* e = reinterpret_cast<const TKV*>(&raw[k]);
#pragma unroll
        for (int v = 0; v < V; ++v) kv[i + v] = to_f32(e[v]);
      }
    }
    __syncthreads();

    // the tile's keys in groups of G: G logits (G independent FMA
    // chains over this thread's columns, summed over the row's P threads
    // by xor shuffles), then the online-softmax update with that group
#pragma unroll 1
    for (int g0 = 0; g0 < KEYS; g0 += G) {
      float dot[G];
#pragma unroll
      for (int u = 0; u < G; ++u) dot[u] = 0.0f;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
#pragma unroll
        for (int u = 0; u < G; ++u) {
          const float4 k4 =
              reinterpret_cast<const float4*>(kv + (g0 + u) * W)[c * P + j];
          dot[u] = fmaf(q[4 * c], k4.x, dot[u]);
          dot[u] = fmaf(q[4 * c + 1], k4.y, dot[u]);
          dot[u] = fmaf(q[4 * c + 2], k4.z, dot[u]);
          dot[u] = fmaf(q[4 * c + 3], k4.w, dot[u]);
        }
      }
      float mg = kNeg;
#pragma unroll
      for (int u = 0; u < G; ++u) {
#pragma unroll
        for (int k = 0; k < LOG2P; ++k) {
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], 1 << k);
        }
        const int tt = t0 + g0 + u;
        dot[u] = (tt < T && tt <= s) ? dot[u] : kNeg;
        mg = fmaxf(mg, dot[u]);
      }
      const float m_new = fmaxf(m, mg);
      const float alpha = expf(m - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        dot[u] = expf(dot[u] - m_new);
        psum += dot[u];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < 4 * CR; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float4* vr = reinterpret_cast<const float4*>(kv + (g0 + u) * W);
#pragma unroll
        for (int c = 0; c < CR; ++c) {
          const float4 v4 = vr[c * P + j];
          acc[4 * c] = fmaf(dot[u], v4.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(dot[u], v4.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(dot[u], v4.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(dot[u], v4.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
  }

  if (s >= S) return;
  const float denom = fmaxf(l, 1e-30f);
  TQ* op = static_cast<TQ*>(a.out) + b * a.os[0] + s * a.os[1] +
           h * a.os[2];
#pragma unroll
  for (int c = 0; c < CR; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      from_f32(op + 4 * (c * P + j) + e, acc[4 * c + e] / denom);
    }
  }
}

template <typename TQ, typename TKV, int R, int DR, int P, int ROWS,
          int KEYS>
cudaError_t launch_one(const Args& a, int B, cudaStream_t stream) {
  constexpr int SMEM = KEYS * (R + DR) * static_cast<int>(sizeof(float));
  auto kernel = mla_kernel<TQ, TKV, R, DR, P, ROWS, KEYS>;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.S + ROWS - 1) / ROWS, a.H, B);
  kernel<<<grid, ROWS * P, SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_typed(const Args& a, int B, int R, int DR,
                         cudaStream_t stream) {
  if (R == 512 && DR == 64) {
    return launch_one<TQ, TKV, 512, 64, 16, 16, 64>(a, B, stream);
  }
  if (R == 32 && DR == 16) {
    return launch_one<TQ, TKV, 32, 16, 4, 32, 64>(a, B, stream);
  }
  if (R == 32 && DR == 8) {
    return launch_one<TQ, TKV, 32, 8, 2, 64, 64>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 13 element strides: (batch, seq, head) of q_lat, q_rope and
// out, then (batch, seq) of c_kv and k_rope.
// q_dtype / kv_dtype: 0 = f32, 1 = bf16; q must be f32 or kv's type.
// c_kv and k_rope, and their batch and row strides, must be 16-byte
// aligned: the latent tiles are staged with 16-byte loads.
extern "C" int mla_attention_launch(const void* q_lat, const void* q_rope,
                                    const void* c_kv, const void* k_rope,
                                    void* out, const long long* strides,
                                    int q_dtype, int kv_dtype, int B, int S,
                                    int T, int H, int R, int DR,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q_lat = q_lat;
  a.q_rope = q_rope;
  a.c_kv = c_kv;
  a.k_rope = k_rope;
  a.out = out;
  a.S = S;
  a.T = T;
  a.H = H;
  for (int i = 0; i < 3; ++i) {
    a.qls[i] = strides[i];
    a.qrs[i] = strides[3 + i];
    a.os[i] = strides[6 + i];
  }
  for (int i = 0; i < 2; ++i) {
    a.cks[i] = strides[9 + i];
    a.krs[i] = strides[11 + i];
  }
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0) {
    err = launch_typed<float, float>(a, B, R, DR, stream);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    err = launch_typed<float, __nv_bfloat16>(a, B, R, DR, stream);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(a, B, R, DR, stream);
  }
  return static_cast<int>(err);
}
