// Flash attention for Hopper (sm_90a): the causal blockwise forward and the
// two Flash-2 backward kernels, over the training layout [B, T, H, D].
//
// Replaces the TPU kernels of mpit_tpu/ops/flash_attention.py:
//   - mma_fwd_kernel (bf16) and fwd_kernel (f32)
//                 <- _fwd_kernel     (called from _fwd_packed, :362)
//   - mma_dq_kernel (bf16) and dq_kernel (f32)
//                 <- _bwd_dq_kernel  (called from _bwd_packed, :408)
//   - mma_dkv_kernel (bf16) and dkv_kernel (f32)
//                 <- _bwd_dkv_kernel (called from _bwd_packed, :428)
//
// What they compute (one head of one sequence at a time; query i and key j
// sit at global positions q_offset + i and k_offset + j; with causal set,
// key j is visible to query i iff q_offset + i >= k_offset + j):
//   s   = f32(q . k) * scale, masked to -1e30 where not visible
//   fwd: o = softmax(s) v through an online softmax over key tiles, with
//        p rounded to v's dtype before the PV product; lse = m + log(l).
//        A row that sees no key gives o = 0 and lse = -1e30.
//   dq:  p = exp(s - lse) (0 where lse <= -5e29), dp = f32(dO . v),
//        ds = p (dp - delta); dq = scale * sum_k round_k(ds) k
//   dkv: dv = sum_q round_dO(p)^T dO; dk = scale * sum_q round_q(ds)^T q
// delta = rowsum(f32(dO) f32(O)) - g_lse comes from the wrapper.
//
// What bounds them on this card: at GPT-2 small's training shape (B 8,
// H 12, T 512, D 64, bf16) each kernel moves 25-38 MB and does 3-6 GFLOP,
// so the bound is the bytes (about 0.01 ms at 3.35 TB/s); the tensor cores
// would do the arithmetic in a few microseconds.
//
// The bf16 forward, mma_fwd_kernel, runs on the tensor cores through the
// shared tile of attn_mma.cuh: 4 warps a block, 16 query rows a warp, the
// Q fragments held in registers for the whole key loop, K and V tiles of
// 64 keys double-buffered through cp.async (tile kb + 1 in flight while
// tile kb is computed, read in place at the inputs' strides), P repacked in
// registers from the score fragments, and the causal mask applied only on
// the tiles that hold a masked key. Rows past T load as zeros and are not
// stored.
//
// The bf16 dk/dv backward, mma_dkv_kernel, runs on the tensor cores with
// the same fragments, turned the other way: 4 warps a block, 16 KEY rows a
// warp, whose K and V A-fragments it holds in registers for the whole query
// loop; tiles of 64 queries (Q, dO, and their lse and delta rows)
// double-buffered through cp.async, each taken by a warp in two halves of
// 32 queries. Per half: S^T = K Q^T and dP^T = V dO^T (B-fragments from Q
// and dO by ldmatrix), p = exp(S^T scale - lse) from the f32 score,
// ds = p (dp - delta) from the unrounded p, then dV += round(p) dO and
// dK += round(ds) Q with the rounded p and ds repacked in registers from
// the C-fragments as A-fragments (P and dS never touch shared memory) and
// the B-fragments from dO and Q by ldmatrix.trans. Every operand of the
// four products is bf16 in the reference too (p.astype(do.dtype),
// ds.astype(q.dtype)), so these are its rounding points one for one. A
// half whose every pair is masked is skipped, the causal mask is applied
// only where a pair is masked, and rows past T load as zeros and are
// masked.
//
// The bf16 dq backward, mma_dq_kernel, is the dk/dv design turned back the
// forward's way: 4 warps a block, 16 QUERY rows a warp, whose Q and dO
// A-fragments (ldmatrix, as Rows16::load_q) and two rows' lse and delta it
// holds in registers for the whole key loop; K and V tiles of 64 keys
// double-buffered through cp.async as in the forward, read in place from
// the fused qkv views, each taken by a warp in two halves of 32 keys. Per
// half: S = Q K^T and dP = dO V^T (B-fragments from K and V by ldmatrix, as
// K's in Rows16::step), p = exp(S scale - lse) from the f32 score,
// ds = p (dp - delta) from the unrounded p, then dQ += round(ds) K with ds
// rounded once to k's dtype in the register repack of the C-fragments into
// A-fragments (dS never touches shared memory) and the B-fragments from K
// by ldmatrix.trans (as V's in the forward's PV step). These are the
// reference's rounding points (ds.astype(k.dtype), f32 accumulation, dq *
// scale rounded once at the end); only the order of the f32 sums differs.
// dq stays its own kernel, as the TPU kernel is, and recomputes S and dP:
// fusing it into dk/dv with atomic adds would make its sums depend on the
// order of the blocks. A query tile that sees no key (each block computes
// its trip count from the offsets) stores dq = 0 exactly.
//
// The f32 forward and both f32 backward kernels do their products with f32
// FMAs on the CUDA cores (for f32 inputs the only way to keep f32
// accuracy), so in practice they are bound by those FMAs
// and the shared-memory reads that feed them. What their design does about
// it: every operand tile is read from device memory once per block and
// staged in shared memory as f32, the [T, T] scores never leave registers
// and shared memory, and fully masked key tiles (forward, dq) or query
// tiles (dkv) are never visited: each block computes its own trip count
// from the offsets, as the TPU kernel does. Each thread holds a 4 x 4
// piece of the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j) so
// that every shared-memory read in the inner loops is either a broadcast
// or 16 consecutive words. Tiles are staged transposed ([D][65]); the odd
// row stride lets the backward's second products read the same tiles
// along the other axis without bank conflicts, so no operand is loaded
// twice.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, T, H, D], all of one dtype, f32
// or bf16; lse and delta are [B, H, T] f32. o, dO, dq, dk and dv are
// contiguous (a head's row is D elements at stride H * D). q, k and v are
// read in place at one batch and row stride shared by the three, so the
// model hands over the split thirds of its fused qkv projection (row
// stride 3 H D) without a copy. Grid (ceil(T / 64), H, B); 128 threads for
// the three tensor-core kernels (mma_*), 256 for the f32 ones.
// The last tile of a T that is not a multiple of 64 is masked: its missing
// rows load as zeros, their keys are masked and their rows are not stored.
//
// C interface for ctypes: mpit_flash_fwd, mpit_flash_dq and mpit_flash_dkv
// return the cudaError_t of the launch (cudaGetLastError right after it),
// or -1 for a dtype or head dimension this file was not instantiated for.
// mpit_flash_path names the body (body_of) a launch runs for a dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per tile
constexpr int NT = 256;  // threads per block: 16 x 16
constexpr int LD = 65;  // row stride of a transposed tile (BQ or BK + 1)
constexpr float NEG_BIG = -1e30f;  // "-inf" that survives subtraction

struct Geo {
  int b, t, h;
  int q_offset, k_offset, causal;
  float scale;
  long long in_bstride, in_tstride;  // q, k, v: elements between batches, rows
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and back: what x.astype(T) feeds a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Reductions over the 16 threads (tx) that share a row of the score tile:
// they are one half of a warp.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Element (b, t, head, 0) of a contiguous [B, T, H, D] tensor.
__device__ __forceinline__ size_t row_index(const Geo& g, int b, int t,
                                            int head, int d) {
  return (((size_t)b * g.t + t) * g.h + head) * d;
}

// Stage the 64-row tile of one head starting at sequence row t0 into shared
// memory as f32: row-major [64][D] or, with TRANS, transposed [D][LD]. With
// IN, src is q, k or v (rows at the inputs' strides), else contiguous.
// Rows past T load as zeros. 16-byte loads (the wrapper checks alignment).
template <typename T, int D, bool TRANS, bool IN = true>
__device__ __forceinline__ void stage(float* dst, const T* src, const Geo& g,
                                      int b, int head, int t0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  static_assert(D % VEC == 0, "a head's row must be whole 16-byte vectors");
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR;
    const int c0 = (i % VPR) * VEC;
    const int t = t0 + r;
    float vals[VEC];
    if (t < g.t) {
      const size_t at =
          IN ? (size_t)(b * g.in_bstride + t * g.in_tstride + head * D)
             : row_index(g, b, t, head, D);
      const uint4 raw = *reinterpret_cast<const uint4*>(src + at + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (TRANS)
        dst[(c0 + j) * LD + r] = vals[j];
      else
        dst[r * D + c0 + j] = vals[j];
    }
  }
}

// Key tiles a query tile must visit: the tiles holding a key visible to
// some row of query tile qi, clip(ceil((qoff + qi*BQ + BQ - koff) / BK),
// 0, nk). Clipped before dividing: C++ division truncates toward zero.
__device__ __forceinline__ int key_tiles(const Geo& g, int qi) {
  const int nk = (g.t + BK - 1) / BK;
  if (!g.causal) return nk;
  const long long limit =
      (long long)g.q_offset + (long long)qi * BQ + BQ - g.k_offset;
  if (limit <= 0) return 0;
  const long long n = (limit + BK - 1) / BK;
  return n < nk ? (int)n : nk;
}

// First query tile that can see key tile ki: clip(floor((koff + ki*BK -
// qoff) / BQ), 0, nq). Clipped at 0 before dividing, for the same reason.
__device__ __forceinline__ int first_query_tile(const Geo& g, int ki) {
  const int nq = (g.t + BQ - 1) / BQ;
  if (!g.causal) return 0;
  const long long first =
      (long long)g.k_offset + (long long)ki * BK - g.q_offset;
  if (first <= 0) return 0;
  const long long n = first / BQ;
  return n < nq ? (int)n : nq;
}

// Scaled, masked score of (query row qrow, key row krow), both relative to
// this block's sequence.
__device__ __forceinline__ float mask_score(const Geo& g, float dot, int qrow,
                                            int krow) {
  const bool ok = qrow < g.t && krow < g.t &&
                  (!g.causal || g.q_offset + qrow >= g.k_offset + krow);
  return ok ? dot * g.scale : NEG_BIG;
}

// exp(s - lse), 0 for a row that saw no key (lse = -1e30 would overflow).
__device__ __forceinline__ float p_from_lse(float s, float lse) {
  return lse <= NEG_BIG / 2 ? 0.f : expf(s - lse);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Geo g) {
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;            // [D][LD]  q tile, transposed
  float* kt = qt + D * LD;     // [D][LD]  k tile, transposed
  float* vs = kt + D * LD;     // [BK][D]  v tile
  float* ps = vs + BK * D;     // [BQ][BK] p, rounded to v's dtype

  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_k = key_tiles(g, qi);

  stage<T, D, true>(qt, q, g, b, head, qi * BQ);
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();  // the previous tile's kt, vs and ps are consumed
    stage<T, D, true>(kt, k, g, b, head, kb * BK);
    stage<T, D, false>(vs, v, g, b, head, kb * BK);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[d * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = kt[d * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = qi * BQ + ty + 16 * i;
      float mx = NEG_BIG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask_score(g, s[i][j], qrow, kb * BK + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * BK + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * BK + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty + 16 * i;
    if (row >= g.t) continue;
    const bool empty = m[i] <= NEG_BIG / 2;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* out = o + row_index(g, b, row, head, D);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[tx + 16 * c] = from_f32<T>(empty ? 0.f : acc[i][c] / l_safe);
    if (tx == 0)
      lse[((size_t)b * g.h + head) * g.t + row] =
          empty ? NEG_BIG : m[i] + logf(l_safe);
  }
}

// The bf16 forward on the tensor cores (attn_mma.cuh). Dynamic shared
// memory: the Q tile, then two stages of K tiles, then two of V tiles, all
// [64][D + 8] bf16.
template <int D>
__global__ void __launch_bounds__(am::THREADS, am::min_blocks<D>())
    mma_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   Geo g) {
  constexpr int TILE = am::TILE_KEYS * am::ld<D>();  // elements of a tile
  extern __shared__ uint4 mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* ks = qs + TILE;      // [2] K tiles
  __nv_bfloat16* vs = ks + 2 * TILE;  // [2] V tiles

  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_k = key_tiles(g, qi);
  const int q0 = qi * BQ + warp * 16;  // first query row of the warp's slab
  const size_t head_at = (size_t)(b * g.in_bstride + head * D);
  const __nv_bfloat16 *q_h = q + head_at, *k_h = k + head_at,
                      *v_h = v + head_at;
  // Row t0 + r of one head of q, k or v at the inputs' strides; nullptr
  // past T.
  auto rows = [&](const __nv_bfloat16* base, int t0) {
    return [=](int r) -> const __nv_bfloat16* {
      return t0 + r < g.t ? base + (size_t)((t0 + r) * g.in_tstride) : nullptr;
    };
  };
  auto stage_kv = [&](int kb, int slot) {
    am::stage_rows<D>(ks + slot * TILE, k_h, rows(k_h, kb * BK));
    am::stage_rows<D>(vs + slot * TILE, v_h, rows(v_h, kb * BK));
  };

  am::stage_rows<D>(qs, q_h, rows(q_h, qi * BQ));
  if (n_k > 0) stage_kv(0, 0);
  am::cp_async_commit();
  am::Rows16<D> tile;
  tile.init();
  for (int kb = 0; kb < n_k; ++kb) {
    const int slot = kb & 1;
    if (kb + 1 < n_k) stage_kv(kb + 1, slot ^ 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();  // tile kb (and, at kb 0, the Q tile) landed
    __syncthreads();
    if (kb == 0) tile.load_q(qs + warp * 16 * am::ld<D>());
    const int k0 = kb * BK;
    const bool masked =
        k0 + BK > g.t ||
        (g.causal && (long long)g.k_offset + k0 + BK - 1 > (long long)g.q_offset + q0);
    tile.step(ks + slot * TILE, vs + slot * TILE, g.scale, masked,
              [&](int r, int c) {
                const int krow = k0 + c;
                return krow < g.t &&
                       (!g.causal || g.q_offset + q0 + r >= g.k_offset + krow);
              });
    __syncthreads();  // every warp is done with this stage before its reuse
  }
  am::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (lane >> 2) + 8 * i;
    if (row >= g.t) continue;
    const bool empty = tile.m[i] <= NEG_BIG / 2;
    const float l_safe = tile.l[i] == 0.f ? 1.f : tile.l[i];
    __nv_bfloat16* out = o + row_index(g, b, row, head, D);
#pragma unroll
    for (int n = 0; n < am::Rows16<D>::ND; ++n) {
      const float x0 = empty ? 0.f : tile.acc[n][2 * i] / l_safe;
      const float x1 = empty ? 0.f : tile.acc[n][2 * i + 1] / l_safe;
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + ((lane & 3) << 1)) =
          __floats2bfloat162_rn(x0, x1);
    }
    if ((lane & 3) == 0)
      lse[((size_t)b * g.h + head) * g.t + row] =
          empty ? NEG_BIG : tile.m[i] + logf(l_safe);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Geo g) {
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* qt = smem;             // [D][LD]  q tile, transposed
  float* dot = qt + D * LD;     // [D][LD]  dO tile, transposed
  float* kt = dot + D * LD;     // [D][LD]  k tile, transposed
  float* vt = kt + D * LD;      // [D][LD]  v tile, transposed
  float* dss = vt + D * LD;     // [BQ][BK] ds, rounded to k's dtype

  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_k = key_tiles(g, qi);

  stage<T, D, true>(qt, q, g, b, head, qi * BQ);
  stage<T, D, true, false>(dot, dout, g, b, head, qi * BQ);
  float row_lse[4], row_delta[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty + 16 * i;
    const size_t at = ((size_t)b * g.h + head) * g.t + row;
    row_lse[i] = row < g.t ? lse[at] : NEG_BIG;
    row_delta[i] = row < g.t ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_k; ++kb) {
    __syncthreads();
    stage<T, D, true>(kt, k, g, b, head, kb * BK);
    stage<T, D, true>(vt, v, g, b, head, kb * BK);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], e[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[d * LD + ty + 16 * i];
        e[i] = dot[d * LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = kt[d * LD + tx + 16 * j];
        w[j] = vt[d * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(e[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = qi * BQ + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sc = mask_score(g, s[i][j], qrow, kb * BK + tx + 16 * j);
        const float p = p_from_lse(sc, row_lse[i]);
        dss[(ty + 16 * i) * BK + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - row_delta[i]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty + 16 * i) * BK + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = kt[(tx + 16 * c) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qi * BQ + ty + 16 * i;
    if (row >= g.t) continue;
    T* out = dq + row_index(g, b, row, head, D);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[tx + 16 * c] = from_f32<T>(acc[i][c] * g.scale);
  }
}

// One block per (key tile, head, batch); rows of the score tile are keys
// (ty + 16 i) and its columns queries (tx + 16 j).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, Geo g) {
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* kt = smem;             // [D][LD]  k tile, transposed (whole block)
  float* vt = kt + D * LD;      // [D][LD]  v tile, transposed (whole block)
  float* qt = vt + D * LD;      // [D][LD]  q tile, transposed
  float* dot = qt + D * LD;     // [D][LD]  dO tile, transposed
  float* pts = dot + D * LD;    // [BK][BQ] p^T, rounded to dO's dtype
  float* dsts = pts + BK * BQ;  // [BK][BQ] ds^T, rounded to q's dtype
  float* lse_s = dsts + BK * BQ;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int ki = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (g.t + BQ - 1) / BQ;
  const int q_start = first_query_tile(g, ki);

  stage<T, D, true>(kt, k, g, b, head, ki * BK);
  stage<T, D, true>(vt, v, g, b, head, ki * BK);
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qb = q_start; qb < nq; ++qb) {
    __syncthreads();
    stage<T, D, true>(qt, q, g, b, head, qb * BQ);
    stage<T, D, true, false>(dot, dout, g, b, head, qb * BQ);
    if (threadIdx.x < BQ) {
      const int row = qb * BQ + threadIdx.x;
      const size_t at = ((size_t)b * g.h + head) * g.t + row;
      lse_s[threadIdx.x] = row < g.t ? lse[at] : NEG_BIG;
      delta_s[threadIdx.x] = row < g.t ? delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], e[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = kt[d * LD + ty + 16 * i];
        e[i] = vt[d * LD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = qt[d * LD + tx + 16 * j];
        w[j] = dot[d * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(e[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = ki * BK + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float sc = mask_score(g, s[i][j], qb * BQ + col, krow);
        const float p = p_from_lse(sc, lse_s[col]);
        pts[(ty + 16 * i) * BQ + col] = round_to<T>(p);
        dsts[(ty + 16 * i) * BQ + col] =
            round_to<T>(p * (dp[i][j] - delta_s[col]));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pts[(ty + 16 * i) * BQ + qq];
        ds[i] = dsts[(ty + 16 * i) * BQ + qq];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float dov = dot[(tx + 16 * c) * LD + qq];
        const float qv = qt[(tx + 16 * c) * LD + qq];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(p[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ki * BK + ty + 16 * i;
    if (row >= g.t) continue;
    const size_t at = row_index(g, b, row, head, D);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[at + tx + 16 * c] = from_f32<T>(dk_acc[i][c] * g.scale);
      dv[at + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// The bf16 dk/dv backward on the tensor cores (see the note at the top).
// Dynamic shared memory: the block's K and V tiles, two stages of Q tiles,
// two of dO tiles (all [64][D + 8] bf16), then two stages of the query
// tile's lse and delta rows (f32 [64] each). At most two blocks an SM: the
// K/V fragments, both accumulators and the half's S^T and dP^T take about
// 4 D + 64 registers a thread (160 at D 64).
template <int D>
constexpr int mma_dkv_smem() {
  return 6 * am::TILE_KEYS * am::ld<D>() * 2 + 2 * 2 * BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(am::THREADS, 2)
    mma_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, Geo g) {
  constexpr int TILE = am::TILE_KEYS * am::ld<D>();  // elements of a tile
  constexpr int KD = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int ND = D / 8;   // 8-column blocks of dK and dV
  constexpr int HALF = 32;    // queries a warp takes at once
  static_assert(am::THREADS == 2 * BQ, "one lse or delta row a thread");
  extern __shared__ uint4 mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* vs = ks + TILE;
  __nv_bfloat16* qs = vs + TILE;        // [2] Q tiles
  __nv_bfloat16* dos = qs + 2 * TILE;   // [2] dO tiles
  float* rows_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][lse, delta]

  const int ki = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (g.t + BQ - 1) / BQ;
  const int q_start = first_query_tile(g, ki);
  const int k0 = ki * BK + warp * 16;  // the warp's first key row
  const size_t head_at = (size_t)(b * g.in_bstride + head * D);
  const __nv_bfloat16 *q_h = q + head_at, *k_h = k + head_at,
                      *v_h = v + head_at;
  // Row t0 + r of one head of q, k or v at the inputs' strides; nullptr
  // past T.
  auto rows = [&](const __nv_bfloat16* base, int t0) {
    return [=](int r) -> const __nv_bfloat16* {
      return t0 + r < g.t ? base + (size_t)((t0 + r) * g.in_tstride) : nullptr;
    };
  };
  // Query tile qb's Q and dO rows, lse and delta (0 past T: those rows are
  // masked) into stage slot.
  auto stage_q = [&](int qb, int slot) {
    const int t0 = qb * BQ;
    am::stage_rows<D>(qs + slot * TILE, q_h, rows(q_h, t0));
    am::stage_rows<D>(dos + slot * TILE, dout,
                      [&](int r) -> const __nv_bfloat16* {
                        return t0 + r < g.t
                                   ? dout + row_index(g, b, t0 + r, head, D)
                                   : nullptr;
                      });
    const int r = threadIdx.x % BQ;
    const bool ok = t0 + r < g.t;
    const size_t at = ((size_t)b * g.h + head) * g.t + (ok ? t0 + r : 0);
    if (threadIdx.x < BQ)
      am::cp_async4(rows_s + slot * 2 * BQ + r, lse + at, ok);
    else
      am::cp_async4(rows_s + slot * 2 * BQ + BQ + r, delta + at, ok);
  };

  if (q_start < nq) {
    am::stage_rows<D>(ks, k_h, rows(k_h, ki * BK));
    am::stage_rows<D>(vs, v_h, rows(v_h, ki * BK));
    stage_q(q_start, 0);
  }
  am::cp_async_commit();

  uint32_t kf[KD][4], vf[KD][4];
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qb = q_start; qb < nq; ++qb) {
    const int slot = (qb - q_start) & 1;
    am::cp_async_wait<0>();  // tile qb (and, first, the K and V tiles) landed
    // ... and every warp is done with tile qb - 1, whose stage the next
    // copies fill.
    __syncthreads();
    if (qb + 1 < nq) stage_q(qb + 1, slot ^ 1);
    am::cp_async_commit();
    if (qb == q_start) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int at = (warp * 16 + (lane & 15)) * am::ld<D>() + kk * 16 +
                       (lane >> 4) * 8;
        am::ldsm_x4(kf[kk], ks + at);
        am::ldsm_x4(vf[kk], vs + at);
      }
    }
    const __nv_bfloat16* q_s = qs + slot * TILE;
    const __nv_bfloat16* do_s = dos + slot * TILE;
    const float* lse_s = rows_s + slot * 2 * BQ;
    const float* delta_s = lse_s + BQ;
#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += HALF) {
      const int q0 = qb * BQ + c0;  // the half's first query row
      // Every pair of the half masked: nothing to add.
      if (q0 >= g.t ||
          (g.causal && (long long)g.q_offset + q0 + HALF - 1 <
                           (long long)g.k_offset + k0))
        continue;
      const bool masked =
          q0 + HALF > g.t || k0 + 16 > g.t ||
          (g.causal &&
           (long long)g.q_offset + q0 < (long long)g.k_offset + k0 + 15);
      // S^T and dP^T of the warp's 16 keys x the half's 32 queries: one
      // ldmatrix.x4 gives the B fragments of two 8-query blocks for one
      // k-step (as K's in attn_mma.cuh's Rows16::step).
      float st[HALF / 8][4], dpt[HALF / 8][4];
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int np = 0; np < HALF / 16; ++np) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int at =
              (c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * am::ld<D>() +
              kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bm[4];
          am::ldsm_x4(bm, q_s + at);
          am::mma_bf16(st[2 * np], kf[kk], bm[0], bm[1]);
          am::mma_bf16(st[2 * np + 1], kf[kk], bm[2], bm[3]);
          am::ldsm_x4(bm, do_s + at);
          am::mma_bf16(dpt[2 * np], vf[kk], bm[0], bm[1]);
          am::mma_bf16(dpt[2 * np + 1], vf[kk], bm[2], bm[3]);
        }
      }
      // p from the f32 score, ds from the unrounded p.
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + am::frag_col(lane, e);  // query of the half
          float x = st[n][e] * g.scale;
          if (masked) {
            const int qrow = q0 + c, krow = k0 + am::frag_row(lane, e);
            const bool ok = qrow < g.t && krow < g.t &&
                            (!g.causal || g.q_offset + qrow >= g.k_offset + krow);
            if (!ok) x = NEG_BIG;
          }
          const float p = p_from_lse(x, lse_s[c0 + c]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[c0 + c]);
        }
      // dV += round(P^T) dO and dK += round(dS^T) Q, 16 queries a k-step:
      // the C fragments of two neighbouring 8-query blocks are the A
      // fragment; ldmatrix.trans of [query][d] rows gives the B fragments
      // of two 8-column blocks (as V's in Rows16::step).
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t ap[4], ads[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 2 * kk + (r >> 1), e = 2 * (r & 1);
          ap[r] = am::pack_bf16(st[n][e], st[n][e + 1]);
          ads[r] = am::pack_bf16(dpt[n][e], dpt[n][e + 1]);
        }
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          const int at =
              (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * am::ld<D>() +
              np * 16 + (lane >> 4) * 8;
          uint32_t bm[4];
          am::ldsm_x4_trans(bm, do_s + at);
          am::mma_bf16(dv_acc[2 * np], ap, bm[0], bm[1]);
          am::mma_bf16(dv_acc[2 * np + 1], ap, bm[2], bm[3]);
          am::ldsm_x4_trans(bm, q_s + at);
          am::mma_bf16(dk_acc[2 * np], ads, bm[0], bm[1]);
          am::mma_bf16(dk_acc[2 * np + 1], ads, bm[2], bm[3]);
        }
      }
    }
  }
  am::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + (lane >> 2) + 8 * i;
    if (row >= g.t) continue;
    const size_t at = row_index(g, b, row, head, D) + ((lane & 3) << 1);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * g.scale,
                                dk_acc[n][2 * i + 1] * g.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// The bf16 dq backward on the tensor cores (see the note at the top).
// Dynamic shared memory: the block's Q and dO tiles, then two stages of K
// tiles and two of V tiles, all [64][D + 8] bf16. At most two blocks an SM
// are asked for: the Q and dO fragments, the dQ accumulator, the half's S
// and dP and the two rows' lse and delta take about D + 36 registers a
// thread before addresses (100 at D 64, 164 at D 128).
template <int D>
constexpr int mma_dq_smem() {
  return 6 * am::TILE_KEYS * am::ld<D>() * 2;
}

template <int D>
__global__ void __launch_bounds__(am::THREADS, 2)
    mma_dq_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, Geo g) {
  constexpr int TILE = am::TILE_KEYS * am::ld<D>();  // elements of a tile
  constexpr int KD = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int ND = D / 8;   // 8-column blocks of dQ
  constexpr int HALF = 32;    // keys a warp takes at once
  extern __shared__ uint4 mma_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* dos = qs + TILE;
  __nv_bfloat16* ks = dos + TILE;     // [2] K tiles
  __nv_bfloat16* vs = ks + 2 * TILE;  // [2] V tiles

  const int qi = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_k = key_tiles(g, qi);
  const int q0 = qi * BQ + warp * 16;  // first query row of the warp's slab
  const size_t head_at = (size_t)(b * g.in_bstride + head * D);
  const __nv_bfloat16 *q_h = q + head_at, *k_h = k + head_at,
                      *v_h = v + head_at;
  // Row t0 + r of one head of q, k or v at the inputs' strides; nullptr
  // past T.
  auto rows = [&](const __nv_bfloat16* base, int t0) {
    return [=](int r) -> const __nv_bfloat16* {
      return t0 + r < g.t ? base + (size_t)((t0 + r) * g.in_tstride) : nullptr;
    };
  };
  auto stage_kv = [&](int kb, int slot) {
    am::stage_rows<D>(ks + slot * TILE, k_h, rows(k_h, kb * BK));
    am::stage_rows<D>(vs + slot * TILE, v_h, rows(v_h, kb * BK));
  };

  const int t0 = qi * BQ;
  if (n_k > 0) {  // a tile that sees no key reads nothing and stores 0
    am::stage_rows<D>(qs, q_h, rows(q_h, t0));
    am::stage_rows<D>(dos, dout, [&](int r) -> const __nv_bfloat16* {
      return t0 + r < g.t ? dout + row_index(g, b, t0 + r, head, D) : nullptr;
    });
    stage_kv(0, 0);
  }
  am::cp_async_commit();

  // The thread's two query rows (slab rows g and g + 8): lse and delta. A
  // row past T takes lse = -1e30, so its p, ds and dq are 0.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (lane >> 2) + 8 * i;
    const size_t at = ((size_t)b * g.h + head) * g.t + row;
    row_lse[i] = row < g.t ? lse[at] : NEG_BIG;
    row_delta[i] = row < g.t ? delta[at] : 0.f;
  }
  uint32_t qf[KD][4], dof[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kb = 0; kb < n_k; ++kb) {
    const int slot = kb & 1;
    if (kb + 1 < n_k) stage_kv(kb + 1, slot ^ 1);
    am::cp_async_commit();
    am::cp_async_wait<1>();  // tile kb (and, at kb 0, the Q and dO tiles) landed
    __syncthreads();
    if (kb == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int at = (warp * 16 + (lane & 15)) * am::ld<D>() + kk * 16 +
                       (lane >> 4) * 8;
        am::ldsm_x4(qf[kk], qs + at);
        am::ldsm_x4(dof[kk], dos + at);
      }
    }
    const __nv_bfloat16* k_s = ks + slot * TILE;
    const __nv_bfloat16* v_s = vs + slot * TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += HALF) {
      const int k0 = kb * BK + c0;  // the half's first key row
      // Every pair of the half masked (or the warp's rows all past T):
      // nothing to add.
      if (q0 >= g.t || k0 >= g.t ||
          (g.causal &&
           (long long)g.q_offset + q0 + 15 < (long long)g.k_offset + k0))
        continue;
      const bool masked =
          k0 + HALF > g.t ||
          (g.causal && (long long)g.k_offset + k0 + HALF - 1 >
                           (long long)g.q_offset + q0);
      // S and dP of the warp's 16 queries x the half's 32 keys: one
      // ldmatrix.x4 gives the B fragments of two 8-key blocks for one
      // k-step (as K's in attn_mma.cuh's Rows16::step).
      float s[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int np = 0; np < HALF / 16; ++np) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int at =
              (c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * am::ld<D>() +
              kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bm[4];
          am::ldsm_x4(bm, k_s + at);
          am::mma_bf16(s[2 * np], qf[kk], bm[0], bm[1]);
          am::mma_bf16(s[2 * np + 1], qf[kk], bm[2], bm[3]);
          am::ldsm_x4(bm, v_s + at);
          am::mma_bf16(dp[2 * np], dof[kk], bm[0], bm[1]);
          am::mma_bf16(dp[2 * np + 1], dof[kk], bm[2], bm[3]);
        }
      }
      // p from the f32 score, ds from the unrounded p.
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;  // which of the thread's two rows
          float x = s[n][e] * g.scale;
          if (masked) {
            const int qrow = q0 + am::frag_row(lane, e);
            const int krow = k0 + n * 8 + am::frag_col(lane, e);
            const bool ok = krow < g.t &&
                            (!g.causal || g.q_offset + qrow >= g.k_offset + krow);
            if (!ok) x = NEG_BIG;
          }
          const float p = p_from_lse(x, row_lse[i]);
          dp[n][e] = p * (dp[n][e] - row_delta[i]);
        }
      // dQ += round(dS) K, 16 keys a k-step: the C fragments of two
      // neighbouring 8-key blocks are the A fragment; ldmatrix.trans of
      // [key][d] rows gives the B fragments of two 8-column blocks (as V's
      // in Rows16::step).
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t ads[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 2 * kk + (r >> 1), e = 2 * (r & 1);
          ads[r] = am::pack_bf16(dp[n][e], dp[n][e + 1]);
        }
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bm[4];
          am::ldsm_x4_trans(
              bm, k_s + (c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            am::ld<D>() +
                      np * 16 + (lane >> 4) * 8);
          am::mma_bf16(acc[2 * np], ads, bm[0], bm[1]);
          am::mma_bf16(acc[2 * np + 1], ads, bm[2], bm[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before its reuse
  }
  am::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + (lane >> 2) + 8 * i;
    if (row >= g.t) continue;
    __nv_bfloat16* out =
        dq + row_index(g, b, row, head, D) + ((lane & 3) << 1);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * i] * g.scale, acc[n][2 * i + 1] * g.scale);
  }
}

// Dynamic shared memory of each kernel, in bytes.
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * LD + BK * D + BQ * BK);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * LD + BQ * BK);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * D * LD + 2 * BK * BQ + 2 * BQ);
}
static_assert(dkv_smem<128>() <= 232448, "dkv tile exceeds shared memory");
// Two blocks an SM fit its 228 KB of shared memory (1 KB of it reserved a
// block) at every head dim.
static_assert(2 * (mma_dkv_smem<128>() + 1024) <= 233472, "mma dkv tiles");
static_assert(2 * (mma_dq_smem<128>() + 1024) <= 233472, "mma dq tiles");

dim3 grid_of(const Geo& g) { return dim3((g.t + 63) / 64, g.h, g.b); }

// Kind 0: forward; 1: dq; 2: dk/dv.
struct Ptrs {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
};

// Opt in to the kernel's dynamic shared memory (above the 48 KB default),
// launch it on the stream, and return the launch's error.
template <typename Kernel, typename... Args>
int run(Kernel kernel, int threads, size_t smem, const Geo& g,
        cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(g), threads, smem, stream>>>(args..., g);
  return (int)cudaGetLastError();
}

// The body a launch of `kind` (0 forward, 1 dq, 2 dk/dv) runs for inputs
// of `dtype` (0 f32, 1 bf16): the tensor cores for bf16, f32 FMAs for f32.
// launch below takes the body from here; exported as mpit_flash_path, by
// whose answer the wrapper counts its launches.
enum Body { BODY_FMA, BODY_MMA };
Body body_of(int kind, int dtype) {
  (void)kind;  // one rule for the three kernels
  return dtype == 1 ? BODY_MMA : BODY_FMA;
}

// Launch `body`'s kernel of `kind`; -1 where that body is not compiled for
// T (the tensor-core kernels take bf16, the FMA kernels here f32).
template <typename T, int D>
int launch(int kind, Body body, const Ptrs& p, const Geo& g,
           cudaStream_t stream) {
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const float* lse = static_cast<const float*>(p.lse_in);
  const float* delta = static_cast<const float*>(p.delta);
  if (body == BODY_MMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (kind == 0) {
        auto kernel = mma_fwd_kernel<D>;
        return run(kernel, am::THREADS, am::tiles_bytes<D>(), g, stream, q,
                   k, v, static_cast<T*>(p.o), static_cast<float*>(p.lse_out));
      }
      if (kind == 1) {
        auto kernel = mma_dq_kernel<D>;
        return run(kernel, am::THREADS, mma_dq_smem<D>(), g, stream, q, k, v,
                   dout, lse, delta, static_cast<T*>(p.dq));
      }
      auto kernel = mma_dkv_kernel<D>;
      return run(kernel, am::THREADS, mma_dkv_smem<D>(), g, stream, q, k, v,
                 dout, lse, delta, static_cast<T*>(p.dk),
                 static_cast<T*>(p.dv));
    }
    return -1;
  }
  if constexpr (std::is_same<T, float>::value) {
    if (kind == 0) {
      auto kernel = fwd_kernel<T, D>;
      return run(kernel, NT, fwd_smem<D>(), g, stream, q, k, v,
                 static_cast<T*>(p.o), static_cast<float*>(p.lse_out));
    }
    if (kind == 1) {
      auto kernel = dq_kernel<T, D>;
      return run(kernel, NT, dq_smem<D>(), g, stream, q, k, v, dout, lse,
                 delta, static_cast<T*>(p.dq));
    }
    auto kernel = dkv_kernel<T, D>;
    return run(kernel, NT, dkv_smem<D>(), g, stream, q, k, v, dout, lse,
               delta, static_cast<T*>(p.dk), static_cast<T*>(p.dv));
  }
  return -1;
}

template <typename T>
int launch_d(int kind, Body body, const Ptrs& p, const Geo& g, int d,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(kind, body, p, g, stream);
    case 32: return launch<T, 32>(kind, body, p, g, stream);
    case 64: return launch<T, 64>(kind, body, p, g, stream);
    case 128: return launch<T, 128>(kind, body, p, g, stream);
    default: return -1;
  }
}

int dispatch(int kind, const Ptrs& p, const Geo& g, int d, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Body body = body_of(kind, dtype);
  if (dtype == 0) return launch_d<float>(kind, body, p, g, d, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(kind, body, p, g, d, s);
  return -1;
}

}  // namespace

extern "C" {

// q, k, v, o [B, T, H, D] of dtype (0 f32, 1 bf16), q, k and v at the
// given batch and row strides (elements); lse [B, H, T] f32.
int mpit_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int t, int h, int d, int q_offset,
                   int k_offset, int causal, long long in_bstride,
                   long long in_tstride, float scale, int dtype,
                   void* stream) {
  const Ptrs p{q, k, v, nullptr, nullptr, nullptr, o, lse, nullptr, nullptr,
               nullptr};
  const Geo g{b, t, h, q_offset, k_offset, causal, scale, in_bstride,
              in_tstride};
  return dispatch(0, p, g, d, dtype, stream);
}

// dq [B, T, H, D]; lse and delta [B, H, T] f32.
int mpit_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int b, int t, int h, int d, int q_offset,
                  int k_offset, int causal, long long in_bstride,
                  long long in_tstride, float scale, int dtype,
                  void* stream) {
  const Ptrs p{q, k, v, dout, lse, delta, nullptr, nullptr, dq, nullptr,
               nullptr};
  const Geo g{b, t, h, q_offset, k_offset, causal, scale, in_bstride,
              in_tstride};
  return dispatch(1, p, g, d, dtype, stream);
}

// dk, dv [B, T, H, D]; lse and delta [B, H, T] f32.
int mpit_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int b, int t, int h, int d,
                   int q_offset, int k_offset, int causal,
                   long long in_bstride, long long in_tstride, float scale,
                   int dtype, void* stream) {
  const Ptrs p{q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, dk, dv};
  const Geo g{b, t, h, q_offset, k_offset, causal, scale, in_bstride,
              in_tstride};
  return dispatch(2, p, g, d, dtype, stream);
}

// The body a launch of `kind` (0 forward, 1 dq, 2 dk/dv) runs for inputs
// of `dtype`: 0 fma, 1 mma.
int mpit_flash_path(int kind, int dtype) { return body_of(kind, dtype); }

const char* mpit_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
