// Causal latent-space flash attention for Hopper (sm_90a): the prefill
// attention of MLA (multi-head latent attention, deepseek-v2).  Two
// kernels, chosen by the latent's type: mla_tc_kernel for a bf16 latent
// (the tensor cores), mla_kernel for an f32 one (the CUDA cores).  Both
// take (r, dr) = (512, 64), (32, 16) and (32, 8).
//
// Both replace the TPU kernel repro/kernels/mla_attention.py
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
// multiple; these kernels read only the T real rows, as the plain
// mla_attention_ref does.  The two agree whenever T = S, the prefill.
//
// mla_kernel: every tensor f32, all arithmetic f32 on the CUDA cores.
// No TF32.
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
// of [c_kv || k_rope] in shared memory ONCE (16-byte loads, all of a
// thread's in flight together), and that one tile serves both products:
// the logits against all W columns and p . c_kv against the first r.  That shared tile is
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
// acc values a thread, 255 registers, 160 bytes spilled: eight keys a
// group or eight threads a row spill more), KEYS = 64 latent rows staged
// (147.5 KB of dynamic shared memory; one block a streaming
// multiprocessor, which the registers force anyway).  At r = 32: 32 rows of P = 4 (dr 16) or 64
// rows of P = 2 (dr 8), 128 threads, 64 latent rows (12 / 10 KB).
//
// What bounds it on the card: operations.  2 * (2r + dr) flops per
// unmasked (s, t) pair per head, 9.35 TFLOP for deepseek-v2's prefill
// of 4 x 4096 tokens (H = 128), so the f32 CUDA-core peak (67 TFLOP/s)
// bounds it at 139.5 ms, against 2.7 ms for its bytes.  As written, a
// float4 read from shared memory feeds four FMAs on each of the two rows
// a warp holds, so shared memory (two wavefronts a read) limits it
// before the FMA pipes do, and the staging is not overlapped with the
// FMAs (8 warps a multiprocessor).  It takes 686 ms at that shape
// (PERF.md section 6).
//
// mla_tc_kernel, a bf16 latent (q f32 or bf16): the tensor cores.  Same
// function and mask.  What bounds it: bf16 tensor-core operations, the
// function's 9.35 TFLOP over 989 TFLOP/s = 9.45 ms at deepseek-v2's
// prefill, against 2.7 ms for its bytes.  Numerics:
//   * logits l = sum_i q_i . [c_kv || k_rope] by bf16 wgmma with f32
//     sums, q_i the QP bf16 pieces of [q_lat || q_rope] (split_bf16; QP =
//     2 for an f32 q, 1 for a bf16 one): the latent is bf16 already and
//     bf16 x bf16 products are exact, so q is kept to about 2^-18;
//   * the mask only on latent tiles that straddle the diagonal or T;
//     p = exp2((x - m) log2(e)), so a row whose logits are all masked so
//     far gets p = 1, which alpha = 0 wipes later; l summed from the f32 p;
//   * acc += (p_hi + p_mid) . c_kv: two register-form products into one
//     f32 accumulator, c_kv read from shared memory in the transposed-B
//     form; out = acc / max(l, 1e-30), rounded once to q's type.
// One piece of q or of p leaves the f32 gate by 43-185x; two of each
// stay at about a quarter of it (tests/test_torch_mla.py emulates this
// arithmetic), and on the card at 0.62 of it at the main shape.
// Design at (512, 64), a block of two consumer warpgroups (256 threads)
// per (b, h, 64 query rows):
//   * registers: a 64 x 512 f32 accumulator is 256 registers a thread for
//     one warpgroup, over the 255 limit, so warpgroup g holds output
//     columns 256 g .. 256 g + 255 (128 registers; P.V by m64n256k16);
//   * logits: the 576-wide contraction is split, warpgroup g computes the
//     partial 64 x 32 tile over columns 288 g .. 288 g + 287 (18 k-steps
//     x QP pieces, SS m64n32k16); the two partials meet in one 8 KB
//     shared buffer (warpgroup 0 writes, named barrier, warpgroup 1 reads
//     and writes its own in place, named barrier, warpgroup 0 reads), and
//     each forms S = own + other: f32 + commutes, so both hold the same S
//     bit for bit and run the same softmax.  The tensor cores issue
//     (QP x 1152 + 2 x 1024) flops a (query, latent row) pair and head,
//     2.0x the function's 2176 with two pieces of each, none of it twice;
//   * shared memory, one block an SM: q's QP pieces (QP x 72 KB, staged
//     once, converted from q's type), a cp.async ring of 2 stages x 32
//     latent rows x 1152 B (72 KB; tile j + 1 in flight while tile j is
//     multiplied), the 8 KB exchange and 1 KB of alignment slack:
//     230,400 B of the 232,448 a block may have at QP = 2 (156,672 at
//     QP = 1); tiles 128-byte swizzled (sm90_bf16.cuh);
//   * order: heads vary fastest (blockIdx.x), so the blocks that read the
//     same c_kv rows run together and share them in L2; query tiles go
//     heaviest first within a sequence.  Each block streams every latent
//     row its rows see from L2 (a model, not a measurement: 78 GB in all
//     at the main shape; the four latents, 19 MB, fit the 50 MB L2).
// At r = 32 one warpgroup does it all: W = 48 (dr 16) or 40 (dr 8) is
// staged as a 64-wide tile (the columns past W zero) and P.V is
// m64n64k16 over its 64 columns, of which the first 32 are written.
// ptxas (-Xptxas -v, sm_90a, this source): at (512, 64) 255 registers
// with an f32 q (40 bytes of stack, 40 bytes spilled) and 254 with a
// bf16 q (no spill); at r = 32 120 and 116, no spill; barriers 0 and 1
// at (512, 64).  On the H100 at 700 W the main shape (f32 q) takes
// 65.0 ms: 144 TFLOP/s of the function's flops, 6.9x the bound,
// 3.5x faster than SDPA's memory-efficient backend (PERF.md section 6).
// A model, not a measurement: each m64n32k16 logit product reads 3 KB
// of shared memory (24 clocks at 128 B a clock) for 16 clocks of tensor
// work, so a 32-row tile costs the block about 1,730 clocks of logits
// and 1,020 of P.V, 22 ms in all at 1.98 GHz; the rest of the 65 ms is
// the two warpgroups waiting in lockstep on the products, the exchange
// and the softmax, none of which overlaps another.
//
// The entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); they refuse an (r, dr) or a type pair they
// have no instantiation for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_bf16.cuh"

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

template <int R, int DR, int P, int ROWS, int KEYS>
__global__ void __launch_bounds__(ROWS * P, 1)
mla_kernel(const Args a) {
  constexpr int THREADS = ROWS * P;
  constexpr int W = R + DR;             // a staged row: [c_kv || k_rope]
  constexpr int CW = W / (4 * P);       // float4 chunks of q per thread
  constexpr int CR = R / (4 * P);       // float4 chunks of acc per thread
  static_assert(W % (4 * P) == 0 && R % (4 * P) == 0, "bad split");
  constexpr int LOG2P = P == 16 ? 4 : P == 8 ? 3 : P == 4 ? 2 : P == 2 ? 1 : 0;
  static_assert((1 << LOG2P) == P && KEYS % G == 0, "bad tile");
  constexpr int V = 4;                  // latent values per 16-byte load
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

  const float* qlp = static_cast<const float*>(a.q_lat) + b * a.qls[0] +
                     h * a.qls[2];
  const float* qrp = static_cast<const float*>(a.q_rope) + b * a.qrs[0] +
                     h * a.qrs[2];
  const float* ckp = static_cast<const float*>(a.c_kv) + b * a.cks[0];
  const float* krp = static_cast<const float*>(a.k_rope) + b * a.krs[0];

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
        x = c < CR ? qlp[s * a.qls[1] + d] : qrp[s * a.qrs[1] + (d - R)];
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
        *reinterpret_cast<uint4*>(kv + i) = raw[k];
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
  float* op = static_cast<float*>(a.out) + b * a.os[0] + s * a.os[1] +
              h * a.os[2];
#pragma unroll
  for (int c = 0; c < CR; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      op[4 * (c * P + j) + e] = acc[4 * c + e] / denom;
    }
  }
}

template <int R, int DR, int P, int ROWS, int KEYS>
cudaError_t launch_one(const Args& a, int B, cudaStream_t stream) {
  constexpr int SMEM = KEYS * (R + DR) * static_cast<int>(sizeof(float));
  auto kernel = mla_kernel<R, DR, P, ROWS, KEYS>;
  if (SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.S + ROWS - 1) / ROWS, a.H, B);
  kernel<<<grid, ROWS * P, SMEM, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Args& a, int B, int R, int DR,
                       cudaStream_t stream) {
  if (R == 512 && DR == 64) {
    return launch_one<512, 64, 16, 16, 64>(a, B, stream);
  }
  if (R == 32 && DR == 16) {
    return launch_one<32, 16, 4, 32, 64>(a, B, stream);
  }
  if (R == 32 && DR == 8) {
    return launch_one<32, 8, 2, 64, 64>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

// ---- bf16 latent: the tensor-core kernel ----------------------------

constexpr int kTcRows = 64;     // query rows per block
constexpr int kTcKeys = 32;     // latent rows per staged tile
constexpr int kTcStages = 2;    // depth of the latent ring
constexpr int kPPieces = 2;     // bf16 pieces of p in P.V
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

template <int R, int DR, int QP>
struct TcShape {
  static constexpr int W = R + DR;                  // [c_kv || k_rope]
  static constexpr int WP = (W + 63) / 64 * 64;     // staged width
  static constexpr int NWG = R > 64 ? 2 : 1;        // consumer warpgroups
  static constexpr int NV = R / NWG > 64 ? R / NWG : 64;  // P.V width a wg
  static constexpr int THREADS = 128 * NWG;
  static constexpr int KS = WP / 16 / NWG;          // logit k-steps a wg
  static constexpr int QB = kTcRows * WP * 2;       // one q piece, bytes
  static constexpr int KB = kTcKeys * WP * 2;       // one latent tile
  static constexpr int XB = NWG == 2 ? 16 * 128 * 4 : 0;  // S exchange
  static constexpr int SMEM = QP * QB + kTcStages * KB + XB + 1024;
  static_assert(R % 8 == 0 && DR % 8 == 0, "a 16-byte chunk crosses c_kv");
  static_assert(WP % (16 * NWG) == 0, "uneven logit split");
  static_assert(NV * NWG >= R && NV % 64 == 0 && NV <= 256, "bad P.V width");
  static_assert(kTcKeys * (WP / 8) % THREADS == 0, "uneven staging");
  static_assert(SMEM <= 232448, "over the shared memory of a block");
};

__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

template <typename TQ, int R, int DR, int QP>
__global__ void __launch_bounds__(TcShape<R, DR, QP>::THREADS, 1)
mla_tc_kernel(const Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  using Sh = TcShape<R, DR, QP>;
  constexpr int W = Sh::W, WP = Sh::WP, NWG = Sh::NWG, NV = Sh::NV;
  constexpr int THREADS = Sh::THREADS, KS = Sh::KS;
  constexpr int QB = Sh::QB, KB = Sh::KB;
  extern __shared__ uint8_t smem_raw[];
  // q piece pc at base + pc QB; latent stage st at base + QP QB + st KB;
  // the S exchange after them
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_addr(smem_raw));
  float* const xbuf =
      reinterpret_cast<float*>(gbase + QP * QB + kTcStages * KB);

  const int h = blockIdx.x;  // heads fastest: they share the latent
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lt = tid % 128;
  const int q0 = qt * kTcRows;
  const int S = a.S, T = a.T;
  // this thread's rows: row0 and row0 + 8; its columns of each 8: col, +1
  const int row0 = q0 + 16 * (lt / 32) + (lt % 32) / 4;
  const int col = 2 * (lt % 4);

  const TQ* qlp = static_cast<const TQ*>(a.q_lat) + b * a.qls[0] +
                  h * a.qls[2];
  const TQ* qrp = static_cast<const TQ*>(a.q_rope) + b * a.qrs[0] +
                  h * a.qrs[2];
  const bf16* ckp = static_cast<const bf16*>(a.c_kv) + b * a.cks[0];
  const bf16* krp = static_cast<const bf16*>(a.k_rope) + b * a.krs[0];

  // the latent tiles any row of this block can see: t < T and t <= s
  const int n = (min(T, q0 + kTcRows) + kTcKeys - 1) / kTcKeys;

  // latent tile i into stage i % kTcStages, one copy group; rows past T
  // and the padding columns past W are zero-filled; past the last tile an
  // empty group keeps the wait counts uniform
  auto stage = [&](int i) {
    if (i < n) {
      const uint32_t dst = base + QP * QB + (i % kTcStages) * KB;
      constexpr int CH = WP / 8;  // 16-byte chunks a staged row
#pragma unroll
      for (int j = 0; j < kTcKeys * CH / THREADS; ++j) {
        const int idx = tid + j * THREADS;
        const int r = idx / CH;
        const int c = idx % CH;
        const int t = i * kTcKeys + r;
        const bool in = t < T && c < W / 8;
        const bf16* src = !in ? ckp
                          : c < R / 8 ? ckp + t * a.cks[1] + 8 * c
                                      : krp + t * a.krs[1] + 8 * (c - R / 8);
        cp_async16(dst + tile_offset<WP, kTcKeys>(r, c), src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  stage(0);

  // q once: [q_lat || q_rope] (zero past W and past S), two columns a
  // thread at a time, split into QP bf16 pieces, stored swizzled
#pragma unroll 4
  for (int j = 0; j < kTcRows * WP / 2 / THREADS; ++j) {
    const int idx = tid + j * THREADS;
    const int r = idx / (WP / 2);
    const int d = 2 * (idx % (WP / 2));
    const int s = q0 + r;
    float x0 = 0.0f, x1 = 0.0f;
    if (s < S && d < W) {
      const TQ* src = d < R ? qlp + s * a.qls[1] + d
                            : qrp + s * a.qrs[1] + (d - R);
      x0 = to_f32(src[0]);
      x1 = to_f32(src[1]);
    }
    uint32_t w[QP];
    split_bf16<QP>(x0, x1, w);
    const uint32_t off = tile_offset<WP, kTcRows>(r, d / 8) + (d % 8) * 2;
#pragma unroll
    for (int pc = 0; pc < QP; ++pc) {
      *reinterpret_cast<uint32_t*>(gbase + pc * QB + off) = w[pc];
    }
  }

  float sc[16];      // this thread's logits, then p, of a 64 x 32 tile
  float o[NV / 2];   // its part of acc: columns NV wg .. NV wg + NV - 1
#pragma unroll
  for (int r = 0; r < 16; ++r) sc[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < NV / 2; ++r) o[r] = 0.0f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < n; ++i) {
    const int t0 = i * kTcKeys;
    stage(i + 1);
    cp_async_wait<1>();  // tile i (and, by now, q's stores) have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t kv_tile = base + QP * QB + (i % kTcStages) * KB;

    // this warpgroup's part of the logits: k-steps KS wg .. KS wg + KS - 1
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
#pragma unroll
      for (int pc = 0; pc < QP; ++pc) {
        wgmma_ss_m64n32(sc, desc_kmajor<WP, kTcRows>(base + pc * QB,
                                                     KS * wg + k),
                        desc_kmajor<WP, kTcKeys>(kv_tile, KS * wg + k),
                        k + pc > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if constexpr (NWG == 2) {
      // S = own + other in both warpgroups (thread lt of each holds the
      // same 16 positions), through one buffer in two turns
      if (wg == 0) {
#pragma unroll
        for (int r = 0; r < 16; ++r) xbuf[r * 128 + lt] = sc[r];
      }
      bar_sync(1, THREADS);
      if (wg == 1) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float other = xbuf[r * 128 + lt];
          xbuf[r * 128 + lt] = sc[r];
          sc[r] = sc[r] + other;
        }
      }
      bar_sync(1, THREADS);
      if (wg == 0) {
#pragma unroll
        for (int r = 0; r < 16; ++r) sc[r] = sc[r] + xbuf[r * 128 + lt];
      }
    }

    const bool masked = t0 + kTcKeys - 1 > q0 || t0 + kTcKeys > T;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int hr = (r / 2) % 2;  // row0 or row0 + 8
      float x = sc[r];
      if (masked) {
        const int s = row0 + 8 * hr;
        const int t = t0 + 8 * (r / 4) + col + r % 2;
        x = (t < T && t <= s) ? x : kNeg;
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
    for (int r = 0; r < 16; ++r) {
      const int hr = (r / 2) % 2;
      // x - m first: a row whose logits are all masked so far has
      // x = m = -1e30 and must get p = 1, as the reference's exp(0)
      sc[r] = exp2f((sc[r] - m[hr]) * kLog2e);
      l[hr] += sc[r];
    }
#pragma unroll
    for (int r = 0; r < NV / 2; ++r) o[r] *= alpha[(r / 2) % 2];
    // latent rows 16 kk .. 16 kk + 15 of p as register operands
    uint32_t pa[kPPieces][2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[kPPieces];
        split_bf16<kPPieces>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], w);
#pragma unroll
        for (int pc = 0; pc < kPPieces; ++pc) pa[pc][kk][j] = w[pc];
      }
    }

    // acc += p . c_kv over this warpgroup's NV columns (NV / 64 column
    // blocks of the tile in)
    const uint32_t v_tile = kv_tile + wg * (NV / 64) * kTcKeys * 128;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int pc = 0; pc < kPPieces; ++pc) {
        wgmma_rs_tb<NV>(o, pa[pc][kk], desc_nmajor<WP, kTcKeys>(v_tile, kk),
                        1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // this stage is refilled by the next iteration
  }

  TQ* op = static_cast<TQ*>(a.out) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lr = l[hr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int s = row0 + 8 * hr;
    if (s >= S) continue;
    const float denom = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int c = NV * wg + 8 * j + col;
      if (c < R) {
        store2(op + s * a.os[1] + c, o[4 * j + 2 * hr] / denom,
               o[4 * j + 2 * hr + 1] / denom);
      }
    }
  }
}

template <typename TQ, int R, int DR, int QP>
cudaError_t launch_tc_one(const Args& a, int B, cudaStream_t stream) {
  using Sh = TcShape<R, DR, QP>;
  auto kernel = mla_tc_kernel<TQ, R, DR, QP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, (a.S + kTcRows - 1) / kTcRows, B);
  kernel<<<grid, Sh::THREADS, Sh::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, int QP>
cudaError_t launch_tc(const Args& a, int B, int R, int DR,
                      cudaStream_t stream) {
  if (R == 512 && DR == 64) {
    return launch_tc_one<TQ, 512, 64, QP>(a, B, stream);
  }
  if (R == 32 && DR == 16) {
    return launch_tc_one<TQ, 32, 16, QP>(a, B, stream);
  }
  if (R == 32 && DR == 8) {
    return launch_tc_one<TQ, 32, 8, QP>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

// strides: 13 element strides: (batch, seq, head) of q_lat, q_rope and
// out, then (batch, seq) of c_kv and k_rope.
Args make_args(const void* q_lat, const void* q_rope, const void* c_kv,
               const void* k_rope, void* out, const long long* strides,
               int S, int T, int H) {
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
  return a;
}

}  // namespace

// mla_kernel: every tensor f32.  c_kv and k_rope, and their batch and
// row strides, must be 16-byte aligned: the latent tiles are staged with
// 16-byte loads.
extern "C" int mla_attention_launch(const void* q_lat, const void* q_rope,
                                    const void* c_kv, const void* k_rope,
                                    void* out, const long long* strides,
                                    int B, int S, int T, int H, int R, int DR,
                                    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(q_lat, q_rope, c_kv, k_rope, out, strides, S, T, H);
  return static_cast<int>(launch_f32(a, B, R, DR, stream));
}

// mla_tc_kernel: c_kv and k_rope bf16, q_dtype 0 = f32 (two pieces) or
// 1 = bf16; (R, DR) = (512, 64), (32, 16) or (32, 8).  The latent's
// alignment as
// for mla_attention_launch (cp.async copies 16 bytes); q is read one
// value at a time and out is written two at a time (contiguous rows).
extern "C" int mla_tc_launch(const void* q_lat, const void* q_rope,
                             const void* c_kv, const void* k_rope, void* out,
                             const long long* strides, int q_dtype, int B,
                             int S, int T, int H, int R, int DR,
                             cudaStream_t stream) {
  if (B <= 0 || S <= 0 || T <= 0 || H <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = make_args(q_lat, q_rope, c_kv, k_rope, out, strides, S, T, H);
  cudaError_t err = cudaErrorInvalidValue;
  if (q_dtype == 0) {
    err = launch_tc<float, 2>(a, B, R, DR, stream);
  } else if (q_dtype == 1) {
    err = launch_tc<__nv_bfloat16, 1>(a, B, R, DR, stream);
  }
  return static_cast<int>(err);
}

// mla_tc_kernel's tiling, for models of its traffic: the query rows a
// block owns and the latent rows of a staged tile.
extern "C" void mla_tc_tiles(int* rows, int* keys) {
  *rows = kTcRows;
  *keys = kTcKeys;
}
