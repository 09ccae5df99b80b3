// Gossip mix kernels for Hopper (sm_90a): Eq. (2) of the paper over the
// packed (n, P) parameter plane, m_i <- sum_j C[i, j] * m_j.
//
// gossip_plane replaces the TPU kernel repro/kernels/gossip_mix.py
// gossip_plane_pallas (body _plane_kernel): out = C @ plane, C (n, n) f32.
// gossip_edges replaces gossip_edges_pallas (body _edges_kernel):
// out[i] = sum_d w[i, d] * plane[idx[i, d]] over padded-ELL tables.
// gossip_mix replaces the legacy K-way MAC gossip_mix_pallas (body
// _kernel): out[r] = sum_k w[r, k] * blocks[k] over (K, M, N) blocks, one
// launch per leaf of the mix_dense_pallas fan-out (see rows_kernel below).
//
// What bounds them on the card: n is small next to P (n = 33 on the main
// path, P up to 15e6), so both read the plane once and write it once:
// 2 * n * P * b bytes against 2 * n^2 * P (dense) or 2 * nnz * P (edges)
// f32 operations.  At n = 33 the dense kernel does about 4 f32 FMAs per
// byte moved and stays under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP/B
// line, so it is bound by bytes; it becomes bound by operations from
// n ~ 80.  What the design does about that:
//   * every plane element is read from device memory once per block of 64
//     output rows, with 16-byte vector loads (the wrappers require a
//     16-byte aligned base and row stride, which PlaneLayout.pack and
//     aligned_plane give), staged through shared memory in chunks of source
//     rows so any n works (n = 1024 included);
//   * C is staged through shared memory in the same chunks and read as a
//     warp-wide broadcast;
//   * the ragged P edge is masked in the kernel, so the wrapper makes no
//     padding copies (the reference pads only for the TPU's tiling);
//   * sums are f32 FMAs on CUDA cores, no TF32 and no tensor cores: the
//     reference accumulates in f32, and low-precision aggregation loses
//     the small OOD deltas the paper measures (DESIGN.md section 3.1).
//
// Accumulation order: ascending source row (dense) or ascending table slot
// d (edges), starting from 0.  With lowp = 1 on a bf16 plane the sum runs
// in bf16 (the mix_in_float32=False ablation): the coefficient, every
// product and every partial sum are rounded to bf16 — exactly what the
// plain PyTorch versions in kernels/gossip_mix.py compute.  The edges
// kernel multiplies and adds without fusing (__fmul_rn / __fadd_rn) so that
// it matches its plain version bit for bit.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;              // column threads in a plane block
constexpr int kTY = 8;               // row threads in a plane block
constexpr int kRPT = 8;              // output rows per thread
constexpr int kRows = kTY * kRPT;    // output rows per plane block
constexpr int kJC = 32;              // source rows staged per chunk
constexpr int kEdgeThreads = 256;    // threads in an edges block
constexpr int kRowThreads = 256;     // threads in a rows block
constexpr int kRowsMax = 8;          // output rows per rows block, at most

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// One block: kRows output rows x (kTX * VEC) plane columns.  The 1-D grid
// runs row blocks fastest, so the blocks sharing a column tile run close
// together in time.
template <typename T, int VEC, bool LOWP>
__global__ void __launch_bounds__(kTX * kTY)
plane_kernel(const float* __restrict__ c, const T* __restrict__ plane,
             T* __restrict__ out, int n, long long p, long long ld,
             int n_row_blocks) {
  constexpr int kCols = kTX * VEC;
  __shared__ float cs[kRows][kJC + 1];
  __shared__ __align__(16) float ps[kJC][kCols];

  const long long bid = blockIdx.x;
  const int row0 = static_cast<int>(bid % n_row_blocks) * kRows;
  const long long col0 = (bid / n_row_blocks) * kCols;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int my_row0 = row0 + ty * kRPT;
  const bool active = my_row0 < n;   // warp-uniform: one warp per ty

  float acc[kRPT][VEC];
#pragma unroll
  for (int r = 0; r < kRPT; ++r)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[r][k] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += kJC) {
    const int jn = min(kJC, n - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < kRows * kJC; e += kTX * kTY) {
      const int r = e / kJC;
      const int jj = e % kJC;
      float v = 0.0f;
      if (row0 + r < n && jj < jn) {
        v = c[static_cast<long long>(row0 + r) * n + j0 + jj];
        if (LOWP) v = bf16_round(v);
      }
      cs[r][jj] = v;
    }
    for (int e = tid; e < kJC * kTX; e += kTX * kTY) {
      const int jj = e / kTX;
      const int vx = e % kTX;
      float v[VEC];
      if (jj < jn) {
        load_vec<T, VEC>(plane + static_cast<long long>(j0 + jj) * ld,
                         col0 + vx * VEC, p, v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < VEC; q += 4) {
        *reinterpret_cast<float4*>(&ps[jj][vx * VEC + q]) =
            make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
    }
    __syncthreads();
    if (active) {
      for (int jj = 0; jj < jn; ++jj) {
        float pv[VEC];
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          const float4 f =
              *reinterpret_cast<const float4*>(&ps[jj][tx * VEC + q]);
          pv[q] = f.x; pv[q + 1] = f.y; pv[q + 2] = f.z; pv[q + 3] = f.w;
        }
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const float cv = cs[ty * kRPT + r][jj];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (LOWP) {
              acc[r][k] = bf16_round(acc[r][k] + bf16_round(cv * pv[k]));
            } else {
              acc[r][k] = fmaf(cv, pv[k], acc[r][k]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = my_row0 + r;
    if (i < n) {
      store_vec<T, VEC>(out + static_cast<long long>(i) * ld,
                        col0 + tx * VEC, p, acc[r]);
    }
  }
}

// One block: destination row i x (kEdgeThreads * VEC) plane columns.  The
// 1-D grid runs destination rows fastest, so the n rows that gather from
// one column tile run close together and share its source rows in L2.
template <typename T, int VEC, bool LOWP>
__global__ void __launch_bounds__(kEdgeThreads)
edges_kernel(const float* __restrict__ w, const int* __restrict__ idx,
             const T* __restrict__ plane, T* __restrict__ out, int n,
             int dmax, long long p, long long ld) {
  extern __shared__ float smem[];
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

// gossip_mix: out[r, l] = sum_k w[r, k] * blocks[k, l] over the (M, N)
// positions l of K source slabs, for R output rows.  The TPU kernel is the
// R = 1 case; mix_dense_pallas vmaps it over the n rows of C for every
// leaf (K = n, M = 1, N = leaf size), and that vmap is still one
// pallas_call, so the port makes it one launch a leaf with R = n.
//
// What bounds it: (K + R) * M * N * b bytes against 2 * R * K * M * N f32
// operations.  At K = R = 33 that is ~8 operations a byte in f32, under
// the card's 20 FLOP/B line: bytes.  The design (a weighted sum of K
// slabs into R outputs, none of the Pallas (bm, bn) blocks or padding):
//   * a block owns one column tile (256 threads x one 16-byte vector, or
//     one element on the scalar path) and up to kRowsMax output rows; the
//     grid runs the row groups of a tile fastest, so a tile's K source
//     slabs are read from device memory about once and from L2 by the
//     other groups (ceil(R / 8) reads in all, not the legacy R + 1);
//   * 16-byte loads and stores when the slabs are contiguous, the base
//     and both row strides 16-byte aligned; any other leaf (N = 129,
//     N = 1, a strided slab) takes the scalar path, chosen inside the
//     launch, so the wrapper neither refuses nor copies it;
//   * sums in f32 in ascending k from 0, multiply and add unfused
//     (__fmul_rn / __fadd_rn), cast to the blocks' type once: equal to
//     gossip_mix_ref bit for bit.
template <typename T, int VEC>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ w, const T* __restrict__ blocks,
            T* __restrict__ out, int r_total, int k_total, long long n,
            long long len, long long sk, long long sm, int rows_per_block,
            int n_row_groups) {
  const long long bid = blockIdx.x;
  const int r0 = static_cast<int>(bid % n_row_groups) * rows_per_block;
  const int nr = min(rows_per_block, r_total - r0);
  const long long l = (bid / n_row_groups) * (kRowThreads * VEC) +
                      static_cast<long long>(threadIdx.x) * VEC;
  if (l >= len) return;
  // the scalar path's source offset inside a slab (M rows of stride sm)
  long long off = l;
  if (VEC == 1) {
    const long long mi = l / n;
    off = mi * sm + (l - mi * n);
  }
  float acc[kRowsMax][VEC];
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.0f;
  const float* wr = w + static_cast<long long>(r0) * k_total;
  for (int k = 0; k < k_total; ++k) {
    const T* src = blocks + static_cast<long long>(k) * sk;
    float x[VEC];
    if constexpr (VEC == 1) {
      if constexpr (sizeof(T) == 4) {
        x[0] = src[off];
      } else {
        x[0] = __bfloat162float(src[off]);
      }
    } else {
      load_vec<T, VEC>(src, l, len, x);
    }
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) {
      if (r < nr) {
        const float wv = __ldg(wr + static_cast<long long>(r) * k_total + k);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[r][v] = __fadd_rn(acc[r][v], __fmul_rn(wv, x[v]));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsMax; ++r) {
    if (r < nr) {
      T* dst = out + static_cast<long long>(r0 + r) * len;
      if constexpr (VEC == 1) {
        if constexpr (sizeof(T) == 4) {
          dst[l] = acc[r][0];
        } else {
          dst[l] = __float2bfloat16_rn(acc[r][0]);
        }
      } else {
        store_vec<T, VEC>(dst, l, len, acc[r]);
      }
    }
  }
}

template <typename T, int VEC>
void launch_rows(const void* w, const void* blocks, void* out, int r_total,
                 int k_total, long long n, long long len, long long sk,
                 long long sm, cudaStream_t stream) {
  // balanced row groups of at most kRowsMax rows (33 rows: 5 groups of 7)
  int groups = (r_total + kRowsMax - 1) / kRowsMax;
  const int rows_per_block = (r_total + groups - 1) / groups;
  groups = (r_total + rows_per_block - 1) / rows_per_block;
  const long long n_tiles =
      (len + kRowThreads * VEC - 1) / (kRowThreads * VEC);
  const long long n_blocks = n_tiles * groups;
  rows_kernel<T, VEC><<<static_cast<unsigned>(n_blocks), kRowThreads, 0,
                        stream>>>(
      static_cast<const float*>(w), static_cast<const T*>(blocks),
      static_cast<T*>(out), r_total, k_total, n, len, sk, sm,
      rows_per_block, groups);
}

template <typename T, int VEC, bool LOWP>
void launch_plane(const void* c, const void* plane, void* out, int n,
                  long long p, long long ld, cudaStream_t stream) {
  const int n_row_blocks = (n + kRows - 1) / kRows;
  const long long n_tiles = (p + kTX * VEC - 1) / (kTX * VEC);
  const long long blocks = n_tiles * n_row_blocks;
  plane_kernel<T, VEC, LOWP><<<static_cast<unsigned>(blocks), kTX * kTY, 0,
                               stream>>>(
      static_cast<const float*>(c), static_cast<const T*>(plane),
      static_cast<T*>(out), n, p, ld, n_row_blocks);
}

template <typename T, int VEC, bool LOWP>
void launch_edges(const void* w, const void* idx, const void* plane,
                  void* out, int n, int dmax, long long p, long long ld,
                  cudaStream_t stream) {
  const long long n_tiles =
      (p + kEdgeThreads * VEC - 1) / (kEdgeThreads * VEC);
  const long long blocks = n_tiles * n;
  const size_t smem = static_cast<size_t>(dmax) * (sizeof(float) + sizeof(int));
  edges_kernel<T, VEC, LOWP><<<static_cast<unsigned>(blocks), kEdgeThreads,
                               smem, stream>>>(
      static_cast<const float*>(w), static_cast<const int*>(idx),
      static_cast<const T*>(plane), static_cast<T*>(out), n, dmax, p, ld);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lowp: accumulate in the plane dtype.
// ld: row stride of both plane and out, in elements.  plane, out and
// ld * element size must be 16-byte aligned (the wrappers check).
extern "C" int gossip_plane_launch(const void* c, const void* plane,
                                   void* out, int n, long long p,
                                   long long ld, int dtype, int lowp,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0) {
    if (dtype == 0) {
      launch_plane<float, 4, false>(c, plane, out, n, p, ld, s);
    } else if (lowp) {
      launch_plane<__nv_bfloat16, 8, true>(c, plane, out, n, p, ld, s);
    } else {
      launch_plane<__nv_bfloat16, 8, false>(c, plane, out, n, p, ld, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gossip_edges_launch(const void* w, const void* idx,
                                   const void* plane, void* out, int n,
                                   int dmax, long long p, long long ld,
                                   int dtype, int lowp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0 && dmax > 0) {
    if (dtype == 0) {
      launch_edges<float, 4, false>(w, idx, plane, out, n, dmax, p, ld, s);
    } else if (lowp) {
      launch_edges<__nv_bfloat16, 8, true>(w, idx, plane, out, n, dmax, p,
                                           ld, s);
    } else {
      launch_edges<__nv_bfloat16, 8, false>(w, idx, plane, out, n, dmax, p,
                                            ld, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out (R, M, N) contiguous = w (R, K) f32 contiguous applied to blocks
// (K, M, N) whose last dimension is contiguous, with slab stride sk and
// row stride sm in elements.  dtype: 0 = float32, 1 = bfloat16 (blocks and
// out).  The 16-byte path needs contiguous slabs (M == 1 or sm == N), a
// 16-byte aligned base, slab stride and output row; otherwise the scalar
// path runs.
extern "C" int gossip_mix_launch(const void* w, const void* blocks,
                                 void* out, int r_total, int k_total,
                                 long long m, long long n, long long sk,
                                 long long sm, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long len = m * n;
  if (r_total > 0 && len > 0) {
    const long long b = dtype == 0 ? 4 : 2;
    const bool vec =
        (m == 1 || sm == n) &&
        reinterpret_cast<unsigned long long>(blocks) % 16 == 0 &&
        reinterpret_cast<unsigned long long>(out) % 16 == 0 &&
        (sk * b) % 16 == 0 && (len * b) % 16 == 0;
    if (dtype == 0) {
      if (vec) {
        launch_rows<float, 4>(w, blocks, out, r_total, k_total, n, len, sk,
                              sm, s);
      } else {
        launch_rows<float, 1>(w, blocks, out, r_total, k_total, n, len, sk,
                              sm, s);
      }
    } else if (vec) {
      launch_rows<__nv_bfloat16, 8>(w, blocks, out, r_total, k_total, n,
                                    len, sk, sm, s);
    } else {
      launch_rows<__nv_bfloat16, 1>(w, blocks, out, r_total, k_total, n,
                                    len, sk, sm, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
