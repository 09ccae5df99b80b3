// Gossip mix kernels for Hopper (sm_90a): Eq. (2) of the paper over the
// packed (n, P) parameter plane, m_i <- sum_j C[i, j] * m_j.
//
// stream_kernel computes out (R, L) = W (R, K) . X (K, L) over K source
// rows of stride sx into R output rows of stride so.  It replaces two TPU
// kernels of repro/kernels/gossip_mix.py:
//   * gossip_plane_pallas (body _plane_kernel): out = C @ plane, C (n, n)
//     f32, R = K = n, sx = so = the plane's row stride; f32 FMAs, or with
//     lowp = 1 on a bf16 plane the mix_in_float32=False ablation, where the
//     coefficient, every product and every partial sum are rounded to bf16;
//   * the legacy K-way MAC gossip_mix_pallas (body _kernel) on contiguous
//     16-byte aligned slabs: out[r] = sum_k w[r, k] * blocks[k], sx = the
//     slab stride, so = the slab length.  The TPU kernel is the R = 1 case;
//     mix_dense_pallas vmaps it over the n rows of C for every leaf (K = n,
//     M = 1, N = leaf size), and that vmap is still one pallas_call, so the
//     port makes it one launch a leaf with R = n.  Multiply and add are not
//     fused (__fmul_rn / __fadd_rn), as in gossip_mix_ref.
// Sums run in f32 in ascending source row from 0 and are cast to the
// output type once, so the plane matches gossip_plane_ref within f32
// rounding (bit for bit under lowp) and gossip_mix matches gossip_mix_ref
// bit for bit.  No tensor cores and no TF32: the reference accumulates in
// f32, and low-precision aggregation loses the small OOD deltas the paper
// measures (DESIGN.md section 3.1).
//
// What bounds it: K and R are the node count (33 on every paper path) and
// L runs to millions, so it reads (K + R) * L * b bytes for 2 * R * K * L
// f32 operations.  At n = 33 that is 8.25 operations a byte in f32 (16.5
// in bf16), under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B line: it
// is bound by bytes, and by operations from n ~ 80 (the n = 1024 scaling
// study).  The unfused pair issues two lane instructions a MAC, so the
// bf16 gossip_mix at n = 33 is bound by issue, not bytes, and the f32 one
// needs its copies and arithmetic to overlap almost fully.  The design:
//   * persistent blocks: the grid is the SM count times the blocks that fit
//     an SM (from the launch plan, kernels/gossip_mix.py mix_plan), and a
//     block walks column tiles of 1 KB a source row (2 KB in f32 above 64
//     rows) with a stride of the grid, so one tile's arithmetic and stores
//     overlap the next tiles' loads;
//   * a ring of >= 3 stages in shared memory, each (a chunk of source
//     rows) x (one tile), filled by 16-byte cp.async copies that every
//     thread issues for its own column vector: at n = 33 two stages of
//     33 KB are in flight a block, two blocks an SM.  cp.async rather than
//     cp.async.bulk because its src-size operand zero-fills the part of a
//     vector past L, so the ragged edge (L not a multiple of the vector
//     width) reads no byte past the row and needs no second path, and the
//     ring needs no producer warp or mbarrier;
//   * every output row of a tile in one block for R <= 64, so a source
//     byte crosses L2 -> SM once; R > 64 takes row blocks of <= 64 rows;
//   * 64 threads a row group and kRpt = 11 output rows a thread, so the
//     33 rows of n = 33 are 3 groups of 11 with no idle warp; a thread's
//     rows x one 16-byte column vector are its accumulators (44 in f32, 88
//     in bf16).  In f32 above 64 rows, where the mix is bound by
//     operations, a thread takes two vectors (88 accumulators): each
//     coefficient read from shared memory then serves 8 columns, not 4.
//     Rows past R in the last group are computed and not stored;
//   * the coefficients sit in shared memory for the block's whole life
//     when the block's rows of them fit 64 KB (K <= 248 at 64 rows a
//     block), else each stage carries its chunk's slice; either way they
//     are laid out [k / 4][slot][4], so one float4 broadcast read serves
//     4 source rows of a thread's row;
//   * source rows in chunks of at most 48 and 64 KB (n = 33 is one
//     chunk), each chunk one ring stage.
//
// edges_kernel replaces gossip_edges_pallas (body _edges_kernel): out[i] =
// sum_d w[i, d] * plane[idx[i, d]] over padded-ELL tables, unfused f32
// sums in ascending table slot d from 0 (bf16 under lowp), so it matches
// its plain version bit for bit.  rows_kernel is gossip_mix's scalar path
// for the slabs the 16-byte copies cannot take (a strided middle
// dimension, an odd or unaligned slab).
//
// The experiment axis.  The sweep engine mixes E experiments' planes at
// once: one (E * n, P) allocation of row stride ld, seen as (E, n, P), with
// one (n, n) matrix (stream_kernel) or one set of (n, dmax) edge weights
// (edges_kernel) an experiment and one shared neighbour table.  The grid
// gains a y index, the experiment: a block offsets its coefficients by
// e * (n * n) or e * (n * dmax) floats and its plane and output by e * n
// rows, and runs exactly the single-experiment block.  An output row sums
// its sources in the same order whatever E is, so a batched launch equals
// E single launches bit for bit, and the table check stays j in [0, n)
// within each experiment.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVecs = 64;                   // threads a row group
constexpr int kVecBytes = kVecs * 16;       // a row group's 16-byte vectors
constexpr int kRpt = 11;                    // output rows a thread
constexpr int kMaxGroups = 6;               // row groups a block
constexpr int kStreamThreads = kVecs * kMaxGroups;
constexpr int kMaxStages = 8;
constexpr int kPlanFields = 11;
constexpr int kMaxExperiments = 65535;   // the grid's y extent
constexpr int kEdgeThreads = 256;    // threads in an edges block
constexpr int kRowThreads = 256;     // threads in a rows block
constexpr int kRowsMax = 8;          // output rows per rows block, at most

enum Arith { kFma = 0, kLowp = 1, kUnfused = 2 };

// The launch plan, field for field as kernels/gossip_mix.py MixPlan.c_args
// passes it: output rows a block and row blocks, row groups (64 threads
// each), source rows a chunk and chunks, ring stages, whether the
// coefficients stay resident, grid, dynamic shared bytes, and 16-byte
// vectors a thread (1, or 2 for f32 where the mix is bound by operations),
// and experiments (the grid's y extent; grid is the x extent).
struct StreamPlan {
  int rows_per_block, row_blocks, groups, chunk, chunks, stages, w_resident;
  int grid, smem, vecs, experiments;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Shared memory: [resident coefficients] then `stages` ring stages, each
// [chunk source rows x vecs KB][the chunk's coefficient slice].
__host__ __device__ __forceinline__ int w_resident_bytes(const StreamPlan& pl,
                                                         int k_total) {
  return pl.w_resident ? pl.groups * kRpt * round4(k_total) * 4 : 0;
}

__host__ __device__ __forceinline__ int w_stage_bytes(const StreamPlan& pl) {
  return pl.w_resident ? 0 : pl.groups * kRpt * round4(pl.chunk) * 4;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the src_bytes past the first are zero-filled
// and not read (src_bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// VEC consecutive elements starting at column col of a row, as floats;
// columns at or beyond p read as 0.  VEC * sizeof(T) is 16 bytes and the
// address is 16-byte aligned (row and stride aligned, col a multiple of
// VEC); only the ragged P edge falls back to scalar accesses.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* row, long long col,
                                         long long p, float* v) {
  static_assert(VEC * sizeof(T) == 16, "one 16-byte vector per access");
  if (col + VEC <= p) {
    if constexpr (sizeof(T) == 4) {
      float4 q = *reinterpret_cast<const float4*>(row + col);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      uint4 q = *reinterpret_cast<const uint4*>(row + col);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __bfloat162float(h[k]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (col + k < p) {
      if constexpr (sizeof(T) == 4) {
        v[k] = row[col + k];
      } else {
        v[k] = __bfloat162float(row[col + k]);
      }
    } else {
      v[k] = 0.0f;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* row, long long col, long long p,
                                          const float* v) {
  if (col + VEC <= p) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(row + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint4 q;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
      for (int k = 0; k < VEC; ++k) h[k] = __float2bfloat16_rn(v[k]);
      *reinterpret_cast<uint4*>(row + col) = q;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (col + k < p) {
      if constexpr (sizeof(T) == 4) {
        row[col + k] = v[k];
      } else {
        row[col + k] = __float2bfloat16_rn(v[k]);
      }
    }
  }
}

// a thread's NV staged 16-byte vectors of one source row (kVecBytes
// apart) as floats (bf16: the high half of a float)
template <typename T, int NV, int VEC>
__device__ __forceinline__ void smem_vec(const unsigned char* p,
                                         float (&v)[VEC]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    float* o = v + nv * E;
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + nv * kVecBytes);
      o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(p + nv * kVecBytes);
      const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = __uint_as_float(u[i] << 16);
        o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
  }
}

// acc += w * x in the arithmetic A (w already rounded to bf16 under kLowp)
template <int A, int VEC>
__device__ __forceinline__ void mac(float (&acc)[VEC], float w,
                                    const float (&x)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if constexpr (A == kFma) {
      acc[e] = fmaf(w, x[e], acc[e]);
    } else if constexpr (A == kLowp) {
      acc[e] = bf16_round(acc[e] + bf16_round(w * x[e]));
    } else {
      acc[e] = __fadd_rn(acc[e], __fmul_rn(w, x[e]));
    }
  }
}

template <int A>
__device__ __forceinline__ float coeff(float w) {
  return A == kLowp ? bf16_round(w) : w;
}

// One stage: kn source rows of the thread's column vectors (xs, NV KB
// apart) into its kRpt rows.  ws points at the thread's first slot of the
// [k / 4][slot][4] coefficients; wstep floats separate two k / 4 blocks.
template <typename T, int A, int NV, int VEC>
__device__ __forceinline__ void consume(float (&acc)[kRpt][VEC],
                                        const unsigned char* xs,
                                        const float* ws, int wstep, int kn) {
  constexpr int kRowBytes = NV * kVecBytes;
  int k = 0;
  for (; k + 4 <= kn; k += 4) {
    float xv[4][VEC];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      smem_vec<T, NV>(xs + (k + q) * kRowBytes, xv[q]);
    }
    const float* wb = ws + (k / 4) * wstep;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      const float4 w4 = *reinterpret_cast<const float4*>(wb + r * 4);
      mac<A>(acc[r], coeff<A>(w4.x), xv[0]);
      mac<A>(acc[r], coeff<A>(w4.y), xv[1]);
      mac<A>(acc[r], coeff<A>(w4.z), xv[2]);
      mac<A>(acc[r], coeff<A>(w4.w), xv[3]);
    }
  }
  for (; k < kn; ++k) {
    float xv[VEC];
    smem_vec<T, NV>(xs + k * kRowBytes, xv);
    const float* wb = ws + (k / 4) * wstep + k % 4;
#pragma unroll
    for (int r = 0; r < kRpt; ++r) mac<A>(acc[r], coeff<A>(wb[r * 4]), xv);
  }
}

// Block b of experiment blockIdx.y (w, x and out offset by ew, ex and eo
// elements an experiment) owns row block b % row_blocks and walks column
// tiles b / row_blocks, + lanes, ... (lanes = grid / row_blocks); a step is one
// (tile, source chunk) and one ring stage.  Thread t computes the rows of
// slots (t / 64) * kRpt .. + kRpt - 1 of its row block at the 16-byte
// column vectors t % 64 + 64 nv (nv < NV) of the tile, so that a warp's
// loads, copies and stores touch 512 consecutive bytes.
template <typename T, int A, int NV>
__global__ void __launch_bounds__(kStreamThreads, 1)
stream_kernel(const float* __restrict__ w, const T* __restrict__ x,
              T* __restrict__ out, int r_total, int k_total, long long len,
              long long sx, long long so, long long ew, long long ex,
              long long eo, StreamPlan pl) {
  constexpr int E = 16 / sizeof(T);            // elements a vector
  constexpr int VEC = NV * E;                  // a thread's columns
  constexpr int kRowBytes = NV * kVecBytes;    // a tile's source row
  constexpr long long kCols = kVecs * VEC;
  extern __shared__ __align__(16) unsigned char stream_smem[];
  w += blockIdx.y * ew;
  x += blockIdx.y * ex;
  out += blockIdx.y * eo;
  const int tid = threadIdx.x;
  const int grp = tid / kVecs;                 // warp-uniform
  const int v = tid % kVecs;
  const int slots = pl.groups * kRpt;
  const int row0 = static_cast<int>(blockIdx.x % pl.row_blocks) *
                   pl.rows_per_block;
  const int rows = min(pl.rows_per_block, r_total - row0);
  const int lanes = gridDim.x / pl.row_blocks;
  const int lane = blockIdx.x / pl.row_blocks;
  const long long n_tiles = (len + kCols - 1) / kCols;
  const int steps =
      lane < n_tiles
          ? static_cast<int>((n_tiles - 1 - lane) / lanes + 1) * pl.chunks
          : 0;
  const int xsb = pl.chunk * kRowBytes;
  const int stage_bytes = xsb + w_stage_bytes(pl);
  unsigned char* ring = stream_smem + w_resident_bytes(pl, k_total);
  const int wkp = pl.w_resident ? round4(k_total) : round4(pl.chunk);

  // C in units of 4 source rows of one slot: unit u = kb * slots + r holds
  // C[row0 + r, k0 + 4 kb .. + 3] at floats 4 u .. 4 u + 3
  if (pl.w_resident) {   // the block's rows of C, once; the first step syncs
    float* ws = reinterpret_cast<float*>(stream_smem);
    for (int u = tid; u < slots * (wkp / 4); u += blockDim.x) {
      const int kb = u / slots;
      const int r = u - kb * slots;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = kb * 4 + q;
        ws[u * 4 + q] = r < rows && k < k_total
                            ? w[static_cast<long long>(row0 + r) * k_total + k]
                            : 0.0f;
      }
    }
  }

  // a lane's first unit of a stage's C slice, and the units between its
  // copies (blockDim / 4 < 2 slots)
  const int wq = tid & 3;
  const int wdu = blockDim.x >> 2;
  const int wkb0 = (tid >> 2) / slots;
  const int wr0 = (tid >> 2) - wkb0 * slots;

  // copies of step s into its stage (nothing past the last step), then
  // one commit, so that the group count stays one a step
  auto issue = [&](int s) {
    if (s < steps) {
      const int c = s % pl.chunks;
      const long long tile = lane + static_cast<long long>(s / pl.chunks) *
                                        lanes;
      const int k0 = c * pl.chunk;
      const int kn = min(pl.chunk, k_total - k0);
      unsigned char* st = ring + (s % pl.stages) * stage_bytes;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const long long col = tile * kCols + (v + nv * kVecs) * E;
        const long long left = len - col;
        const int bytes = left >= E ? 16
                          : left > 0 ? static_cast<int>(left * sizeof(T))
                                     : 0;
        const T* src = x + static_cast<long long>(k0) * sx + col;
        const uint32_t dst = smem_addr(st) + nv * kVecBytes + v * 16;
        for (int kk = grp; kk < kn; kk += pl.groups) {
          cp_async16(dst + kk * kRowBytes, bytes ? src + kk * sx : x, bytes);
        }
      }
      if (!pl.w_resident) {   // the chunk's slice of C, float 4 u + q a lane
        const uint32_t wd = smem_addr(st + xsb);
        int kb = wkb0, r = wr0;
        for (int u = tid >> 2; u < slots * (wkp / 4); u += wdu) {
          const bool in = r < rows && kb * 4 + wq < kn;
          cp_async4(wd + (u * 4 + wq) * 4,
                    in ? w + static_cast<long long>(row0 + r) * k_total + k0 +
                             kb * 4 + wq
                       : w,
                    in ? 4 : 0);
          for (r += wdu; r >= slots; r -= slots) ++kb;
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < pl.stages - 1; ++s) issue(s);
  float acc[kRpt][VEC];
#pragma unroll
  for (int r = 0; r < kRpt; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;
  const int slot0 = grp * kRpt;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_pending(pl.stages - 2);   // this thread's step-s copies
    __syncthreads();   // everyone's step-s copies; step s - 1 consumed
    issue(s + pl.stages - 1);               // into step s - 1's stage
    const int c = s % pl.chunks;
    const int kn = min(pl.chunk, k_total - c * pl.chunk);
    const unsigned char* st = ring + (s % pl.stages) * stage_bytes;
    const float* ws =
        pl.w_resident
            ? reinterpret_cast<const float*>(stream_smem) +
                  (c * pl.chunk / 4) * slots * 4
            : reinterpret_cast<const float*>(st + xsb);
    consume<T, A, NV>(acc, st + v * 16, ws + slot0 * 4, slots * 4, kn);
    if (c == pl.chunks - 1) {
      const long long tile = lane + static_cast<long long>(s / pl.chunks) *
                                        lanes;
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        if (slot0 + r < rows) {
          T* dst = out + static_cast<long long>(row0 + slot0 + r) * so;
#pragma unroll
          for (int nv = 0; nv < NV; ++nv) {
            store_vec<T, E>(dst, tile * kCols + (v + nv * kVecs) * E, len,
                            acc[r] + nv * E);
          }
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = 0.0f;
      }
    }
  }
}

// One block: destination row i x (kEdgeThreads * VEC) plane columns of
// experiment blockIdx.y (its weights n * dmax floats on, its plane and
// output n * ld elements on; the table is shared).  The grid's x index
// runs destination rows fastest, so the n rows that gather from one column
// tile run close together and share its source rows in L2.
template <typename T, int VEC, bool LOWP>
__global__ void __launch_bounds__(kEdgeThreads)
edges_kernel(const float* __restrict__ w, const int* __restrict__ idx,
             const T* __restrict__ plane, T* __restrict__ out, int n,
             int dmax, long long p, long long ld) {
  extern __shared__ float smem[];
  w += static_cast<long long>(blockIdx.y) * n * dmax;
  plane += static_cast<long long>(blockIdx.y) * n * ld;
  out += static_cast<long long>(blockIdx.y) * n * ld;
  float* ws = smem;
  int* is = reinterpret_cast<int*>(smem + dmax);
  const long long bid = blockIdx.x;
  const int i = static_cast<int>(bid % n);
  const long long col = (bid / n) * (kEdgeThreads * VEC) +
                        static_cast<long long>(threadIdx.x) * VEC;
  for (int d = threadIdx.x; d < dmax; d += kEdgeThreads) {
    const int j = idx[static_cast<long long>(i) * dmax + d];
    if (j < 0 || j >= n) __trap();  // a table index outside the plane
    float wv = w[static_cast<long long>(i) * dmax + d];
    ws[d] = LOWP ? bf16_round(wv) : wv;
    is[d] = j;
  }
  __syncthreads();
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
  for (int d = 0; d < dmax; ++d) {
    float v[VEC];
    load_vec<T, VEC>(plane + static_cast<long long>(is[d]) * ld, col, p, v);
    const float wv = ws[d];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      if (LOWP) {
        acc[k] = bf16_round(acc[k] + bf16_round(wv * v[k]));
      } else {
        acc[k] = __fadd_rn(acc[k], __fmul_rn(wv, v[k]));
      }
    }
  }
  store_vec<T, VEC>(out + static_cast<long long>(i) * ld, col, p, acc);
}

// gossip_mix's scalar path: one element of the (M, N) positions a thread,
// up to kRowsMax output rows a block; the grid runs the row groups of a
// tile fastest, so a tile's K source slabs are read from device memory
// about once and from L2 by the other groups.  Sums in f32 in ascending k
// from 0, multiply and add unfused, cast once: gossip_mix_ref bit for bit.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ w, const T* __restrict__ blocks,
            T* __restrict__ out, int r_total, int k_total, long long n,
            long long len, long long sk, long long sm, int rows_per_block,
            int n_row_groups) {
  const long long bid = blockIdx.x;
  const int r0 = static_cast<int>(bid % n_row_groups) * rows_per_block;
  const int nr = min(rows_per_block, r_total - r0);
  const long long l = (bid / n_row_groups) * kRowThreads +
                      static_cast<long long>(threadIdx.x);
  if (l >= len) return;
  // the source offset inside a slab (M rows of stride sm)
  const long long mi = l / n;
  const long long off = mi * sm + (l - mi * n);
  float acc[kRowsMax];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) acc[r] = 0.0f;
  const float* wr = w + static_cast<long long>(r0) * k_total;
  for (int k = 0; k < k_total; ++k) {
    const T* src = blocks + static_cast<long long>(k) * sk;
    float x;
    if constexpr (sizeof(T) == 4) {
      x = src[off];
    } else {
      x = __bfloat162float(src[off]);
    }
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) {
      if (r < nr) {
        const float wv = __ldg(wr + static_cast<long long>(r) * k_total + k);
        acc[r] = __fadd_rn(acc[r], __fmul_rn(wv, x));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    if (r < nr) {
      T* dst = out + static_cast<long long>(r0 + r) * len;
      if constexpr (sizeof(T) == 4) {
        dst[l] = acc[r];
      } else {
        dst[l] = __float2bfloat16_rn(acc[r]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_rows(const void* w, const void* blocks, void* out,
                        int r_total, int k_total, long long n, long long len,
                        long long sk, long long sm, cudaStream_t stream) {
  // balanced row groups of at most kRowsMax rows (33 rows: 5 groups of 7)
  int groups = (r_total + kRowsMax - 1) / kRowsMax;
  const int rows_per_block = (r_total + groups - 1) / groups;
  groups = (r_total + rows_per_block - 1) / rows_per_block;
  const long long n_tiles = (len + kRowThreads - 1) / kRowThreads;
  const long long n_blocks = n_tiles * groups;
  rows_kernel<T><<<static_cast<unsigned>(n_blocks), kRowThreads, 0,
                   stream>>>(
      static_cast<const float*>(w), static_cast<const T*>(blocks),
      static_cast<T*>(out), r_total, k_total, n, len, sk, sm, rows_per_block,
      groups);
  return cudaGetLastError();
}

// Checks the plan against the operands (a plan for other shapes would
// leave rows or source rows out, or overrun shared memory) and launches.
template <typename T, int A, int NV>
cudaError_t launch_stream_nv(const void* w, const void* x, void* out,
                             int r_total, int k_total, long long len,
                             long long sx, long long so, long long ew,
                             long long ex, long long eo, const StreamPlan& pl,
                             cudaStream_t stream) {
  if (pl.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<T, A, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        pl.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // returned here; not left for a later launch
      return err;
    }
  }
  const dim3 grid(pl.grid, pl.experiments);
  stream_kernel<T, A, NV><<<grid, pl.groups * kVecs, pl.smem, stream>>>(
      static_cast<const float*>(w), static_cast<const T*>(x),
      static_cast<T*>(out), r_total, k_total, len, sx, so, ew, ex, eo, pl);
  return cudaGetLastError();
}

template <typename T, int A>
cudaError_t launch_stream(const void* w, const void* x, void* out,
                          int r_total, int k_total, long long len,
                          long long sx, long long so, long long ew,
                          long long ex, long long eo, const long long* plan,
                          cudaStream_t stream) {
  if (plan == nullptr) return cudaErrorInvalidValue;
  for (int i = 0; i < kPlanFields; ++i) {
    if (plan[i] < 0 || plan[i] > (1LL << 30)) return cudaErrorInvalidValue;
  }
  StreamPlan pl;
  pl.rows_per_block = static_cast<int>(plan[0]);
  pl.row_blocks = static_cast<int>(plan[1]);
  pl.groups = static_cast<int>(plan[2]);
  pl.chunk = static_cast<int>(plan[3]);
  pl.chunks = static_cast<int>(plan[4]);
  pl.stages = static_cast<int>(plan[5]);
  pl.w_resident = static_cast<int>(plan[6]);
  pl.grid = static_cast<int>(plan[7]);
  pl.smem = static_cast<int>(plan[8]);
  pl.vecs = static_cast<int>(plan[9]);
  pl.experiments = static_cast<int>(plan[10]);
  const bool ok =
      pl.experiments >= 1 && pl.experiments <= kMaxExperiments &&
      pl.groups >= 1 && pl.groups <= kMaxGroups && pl.rows_per_block >= 1 &&
      pl.rows_per_block <= pl.groups * kRpt && pl.row_blocks >= 1 &&
      static_cast<long long>(pl.row_blocks) * pl.rows_per_block >= r_total &&
      (pl.row_blocks - 1) * pl.rows_per_block < r_total && pl.chunk >= 1 &&
      pl.chunks >= 1 &&
      static_cast<long long>(pl.chunks) * pl.chunk >= k_total &&
      (pl.chunks - 1) * pl.chunk < k_total &&
      (pl.chunks == 1 || pl.chunk % 4 == 0) && pl.stages >= 2 &&
      pl.stages <= kMaxStages && pl.grid >= 1 &&
      pl.grid % pl.row_blocks == 0 &&
      (pl.vecs == 1 || (pl.vecs == 2 && sizeof(T) == 4)) &&
      pl.smem == w_resident_bytes(pl, k_total) +
                     pl.stages * (pl.chunk * pl.vecs * kVecBytes +
                                  w_stage_bytes(pl));
  if (!ok) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    if (pl.vecs == 2) {
      return launch_stream_nv<T, A, 2>(w, x, out, r_total, k_total, len, sx,
                                       so, ew, ex, eo, pl, stream);
    }
  }
  return launch_stream_nv<T, A, 1>(w, x, out, r_total, k_total, len, sx, so,
                                   ew, ex, eo, pl, stream);
}

template <typename T, int VEC, bool LOWP>
cudaError_t launch_edges(const void* w, const void* idx, const void* plane,
                         void* out, int n, int dmax, long long p,
                         long long ld, int experiments, cudaStream_t stream) {
  const long long n_tiles =
      (p + kEdgeThreads * VEC - 1) / (kEdgeThreads * VEC);
  const long long blocks = n_tiles * n;
  const size_t smem = static_cast<size_t>(dmax) * (sizeof(float) + sizeof(int));
  const dim3 grid(static_cast<unsigned>(blocks), experiments);
  edges_kernel<T, VEC, LOWP><<<grid, kEdgeThreads, smem, stream>>>(
      static_cast<const float*>(w), static_cast<const int*>(idx),
      static_cast<const T*>(plane), static_cast<T*>(out), n, dmax, p, ld);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lowp: accumulate in the plane dtype.
// ld: row stride of both plane and out, in elements.  plane, out and
// ld * element size must be 16-byte aligned (the wrappers check).
// experiments: E planes of n rows, one after the other (E * n rows of
// stride ld), and E (n, n) matrices.  plan: kPlanFields int64 values of
// mix_plan(n, n, p, dtype, sms, E), host memory; its experiment count must
// be E.
extern "C" int gossip_plane_launch(const void* c, const void* plane,
                                   void* out, int n, long long p,
                                   long long ld, int experiments, int dtype,
                                   int lowp, void* stream,
                                   const long long* plan) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan == nullptr || experiments < 1 || plan[10] != experiments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ew = static_cast<long long>(n) * n;
  const long long ex = static_cast<long long>(n) * ld;
  cudaError_t err = cudaSuccess;
  if (n > 0 && p > 0) {
    if (dtype == 0) {
      err = launch_stream<float, kFma>(c, plane, out, n, n, p, ld, ld, ew, ex,
                                       ex, plan, s);
    } else if (lowp) {
      err = launch_stream<__nv_bfloat16, kLowp>(c, plane, out, n, n, p, ld,
                                                ld, ew, ex, ex, plan, s);
    } else {
      err = launch_stream<__nv_bfloat16, kFma>(c, plane, out, n, n, p, ld, ld,
                                               ew, ex, ex, plan, s);
    }
  }
  return static_cast<int>(err);
}

// experiments: E planes of n rows (E * n rows of stride ld) and E (n, dmax)
// weight tables against one shared (n, dmax) index table.
extern "C" int gossip_edges_launch(const void* w, const void* idx,
                                   const void* plane, void* out, int n,
                                   int dmax, long long p, long long ld,
                                   int experiments, int dtype, int lowp,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (experiments < 1 || experiments > kMaxExperiments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (n > 0 && p > 0 && dmax > 0) {
    if (dtype == 0) {
      err = launch_edges<float, 4, false>(w, idx, plane, out, n, dmax, p, ld,
                                          experiments, s);
    } else if (lowp) {
      err = launch_edges<__nv_bfloat16, 8, true>(w, idx, plane, out, n, dmax,
                                                 p, ld, experiments, s);
    } else {
      err = launch_edges<__nv_bfloat16, 8, false>(w, idx, plane, out, n, dmax,
                                                  p, ld, experiments, s);
    }
  }
  return static_cast<int>(err);
}

// out (R, M, N) contiguous = w (R, K) f32 contiguous applied to blocks
// (K, M, N) whose last dimension is contiguous, with slab stride sk and
// row stride sm in elements.  dtype: 0 = float32, 1 = bfloat16 (blocks and
// out).  The streaming kernel takes contiguous slabs (M == 1 or sm == N)
// with a 16-byte aligned base, slab stride and output row, under plan
// (mix_plan(R, K, M * N, dtype, sms)); any other leaf takes rows_kernel.
extern "C" int gossip_mix_launch(const void* w, const void* blocks,
                                 void* out, int r_total, int k_total,
                                 long long m, long long n, long long sk,
                                 long long sm, int dtype, void* stream,
                                 const long long* plan) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long len = m * n;
  cudaError_t err = cudaSuccess;
  if (r_total > 0 && len > 0) {
    const long long b = dtype == 0 ? 4 : 2;
    const bool vec =
        (m == 1 || sm == n) &&
        reinterpret_cast<unsigned long long>(blocks) % 16 == 0 &&
        reinterpret_cast<unsigned long long>(out) % 16 == 0 &&
        (sk * b) % 16 == 0 && (len * b) % 16 == 0;
    if (vec && (plan == nullptr || plan[10] != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (dtype == 0) {
      err = vec ? launch_stream<float, kUnfused>(w, blocks, out, r_total,
                                                 k_total, len, sk, len, 0, 0,
                                                 0, plan, s)
                : launch_rows<float>(w, blocks, out, r_total, k_total, n, len,
                                     sk, sm, s);
    } else {
      err = vec ? launch_stream<__nv_bfloat16, kUnfused>(
                      w, blocks, out, r_total, k_total, len, sk, len, 0, 0, 0,
                      plan, s)
                : launch_rows<__nv_bfloat16>(w, blocks, out, r_total,
                                             k_total, n, len, sk, sm, s);
    }
  }
  return static_cast<int>(err);
}
