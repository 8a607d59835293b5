// Tensor-core attention tiles for Hopper (sm_90a), shared by the bf16 flash
// forward (flash_attention.cu, mma_fwd_kernel), the bf16 flash dk/dv and
// dq backward (flash_attention.cu, mma_dkv_kernel and mma_dq_kernel, which
// use the fragment helpers below) and the two tensor-core bodies of the flash-decode kernel
// (decode_attention.cu: mma_decode_kernel, over bf16 K/V as the mma body and
// over int8 K/V as the q8mma body).
//
// What Rows16 computes. One warp owns a slab of 16 query rows, whose bf16 Q
// fragments it holds in registers for the whole key loop. For each tile of
// 64 keys staged in shared memory (K and V rows, bf16) it does the flash
// step of the TPU kernels (mpit_tpu/ops/flash_attention.py::_fwd_kernel and
// mpit_tpu/ops/decode_attention.py::_decode_kernel):
//   1. S = Q K^T in f32 from bf16 operands (mma.sync m16n8k16: bf16
//      products are exact in f32, sums in f32);
//   2. S * scale, then masked scores set to -1e30 (only on a tile the
//      caller marks as needing a mask);
//   3. the online softmax in f32: m_new = max(m, rowmax S),
//      p = exp(S - m_new), alpha = exp(m - m_new), l = alpha l + rowsum p,
//      summed from the UNROUNDED f32 p;
//   4. p rounded once to bf16, to nearest even (p.astype(v.dtype));
//   5. acc = alpha acc + P V in f32.
// Rounding points kept from the reference: q and k enter the product as the
// bf16 values they are (its preferred_element_type=f32 dot), the scale
// multiplies the f32 score, l sums the unrounded p, and the PV product sees
// p rounded once to bf16. Only the order of the f32 sums differs (the mma's
// own order, then the quad reductions below).
//
// The int8 form (step<true>) runs the same step over int8 K and V rows that
// the caller has converted to bf16 (exact: |x| <= 128 needs 8 bits), with
// each key's f32 scales ks_j and vs_j. The reference dequantizes K and V
// to f32 and keeps p in f32 against the f32 V, so:
//   - s_j = (q . k_int,j) * ks_j * scale: the dot is one bf16 product with
//     exact products and f32 sums, the scale applied to the f32 score
//     (the reference's q . (k_int,j ks_j) differs in the last bit only);
//   - w_j = p_j * vs_j in f32, split into three bf16 pieces hi = bf16(w),
//     mid = bf16(w - hi), lo = bf16(w - hi - mid) (each subtraction exact;
//     hi + mid + lo is w to within 2^-27 |w|), and three PV products of the
//     pieces against the exact bf16 V_int run into one f32 accumulator: f32
//     products, as the reference's f32 p against f32 V. l sums the
//     unrounded p, as above. A masked key has p = 0, so all three pieces are
//     0.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16 operands; lane = 4 g + t,
// g = lane / 4, t = lane % 4):
//   A (16 x 16, rows x k): reg 0 = (g, 2t..2t+1), reg 1 = (g + 8, 2t..),
//       reg 2 = (g, 2t + 8..), reg 3 = (g + 8, 2t + 8..);
//   B (16 x 8, k x cols): reg 0 = (k 2t..2t+1, col g), reg 1 = (k 2t + 8.., g);
//   C (16 x 8, f32): elements 0, 1 = (g, 2t..2t+1), 2, 3 = (g + 8, 2t..).
// So S arrives as C fragments of 8-key blocks, and the C fragments of two
// neighbouring key blocks are, element for element, the A fragment of the
// PV product over those 16 keys: P never goes through shared memory. A
// row's values sit in the four lanes of a quad; xor-shuffles over lanes 1
// and 2 reduce them.
//
// Shared-memory tiles are [64][D + 8] bf16: the 8 row addresses of one
// ldmatrix 8 x 8 matrix then fall 16 bytes apart modulo 128, in distinct
// banks. ldmatrix loads Q and K as they lie ([row][d]); V goes through
// ldmatrix.trans, which hands each lane its B fragment of [key][d] rows.
// Tiles are filled with 16-byte cp.async.cg copies (rows the caller marks
// invalid are zero-filled), grouped with commit_group / wait_group so that
// the next tile's copies run while the current one is computed.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace attn_mma {

constexpr float NEG_BIG = -1e30f;  // masked score; exp underflows to 0
constexpr int WARPS = 4;           // warps of a block, 16 query rows each
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROWS = 16 * WARPS;  // query rows of a block
constexpr int TILE_KEYS = 64;          // keys of a staged tile

// Blocks an SM should hold at once (the second __launch_bounds__ value):
// up to head dim 64 four (at most 128 registers a thread, 4 x 46 KB of
// tiles), which keeps four tile loads in flight an SM; at 128 the
// accumulators need about 210 registers, and two fit.
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D <= 64 ? 4 : 2;
}

// Row stride, in elements, of a staged [64][D] bf16 tile.
template <int D>
__host__ __device__ constexpr int ld() {
  return D + 8;
}

// Bytes of shared memory a block stages: its Q tile and two stages of K
// and V tiles.
template <int D>
__host__ __device__ constexpr int tiles_bytes() {
  return 5 * TILE_KEYS * ld<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with valid false nothing is read
// (src need only be a mapped address) and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (the int8 forms' per-row scales).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory, as mma fragments. No memory
// clobber: what they read was published by cp_async_wait (which has one)
// and a barrier, and leaving it out lets the compiler keep other values in
// registers across the loads.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b over one 16 x 8 x 16 step, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half: one .b32 of
// an A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two f32 as three packed bf16 pairs whose sum is each value to within
// 2^-27 of it: hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid),
// each rounded to nearest even (the subtractions are exact in f32).
__device__ __forceinline__ void split3(float w0, float w1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  const float r0 = w0 - __low2float(h), r1 = w1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Row (0..15) of a slab, and column (0..7) of an 8-column block, of element
// e (0..3) of the C fragment that lane holds.
__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int lane, int e) {
  return ((lane & 3) << 1) + (e & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage 64 rows of D bf16 into dst ([64][ld<D>()]) with cp.async, every
// thread of the block taking part. src_row(r) is row r's first element, or
// nullptr for a row to zero-fill (then `mapped` stands in as the address).
template <int D, typename RowPtr>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* mapped,
                                           RowPtr src_row) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  for (int i = threadIdx.x; i < TILE_KEYS * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const __nv_bfloat16* src = src_row(r);
    cp_async16(dst + r * ld<D>() + c, src ? src + c : mapped, src != nullptr);
  }
}

// One warp's 16 query rows: Q fragments, online-softmax state and the
// output accumulators. Row i of the state (m[i], l[i], acc[.][2i..2i+1]) is
// slab row g + 8 i.
template <int D>
struct Rows16 {
  static constexpr int KD = D / 16;          // k-steps of Q K^T
  static constexpr int ND = D / 8;           // 8-column blocks of the output
  static constexpr int NK = TILE_KEYS / 8;   // 8-key blocks of a tile

  uint32_t q[KD][4];
  float m[2], l[2], acc[ND][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_BIG;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  // The Q fragments of the slab whose row 0 is q_s (a staged tile's rows).
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q_s) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      ldsm_x4(q[ks], q_s + (lane & 15) * ld<D>() + ks * 16 + (lane >> 4) * 8);
  }

  // One staged tile of 64 keys. visible(r, c) says whether key c of the
  // tile is visible to slab row r; it is asked only when masked is set.
  // With Q8, the tile's keys are int8 rows converted to bf16 in k_s and
  // v_s, and k_scale[c], v_scale[c] are key c's scales (the header's int8
  // form).
  template <bool Q8 = false, typename Visible>
  __device__ __forceinline__ void step(const __nv_bfloat16* k_s,
                                       const __nv_bfloat16* v_s, float scale,
                                       bool masked, Visible visible,
                                       const float* k_scale = nullptr,
                                       const float* v_scale = nullptr) {
    const int lane = threadIdx.x & 31;
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // S = Q K^T: one ldmatrix.x4 gives the B fragments of two 8-key blocks
    // for one k-step (matrices: keys 0-7 d 0-7, keys 0-7 d 8-15, keys 8-15
    // d 0-7, keys 8-15 d 8-15).
#pragma unroll
    for (int np = 0; np < NK / 2; ++np) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld<D>() +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], q[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], q[ks], b[2], b[3]);
      }
    }
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if constexpr (Q8) x *= k_scale[n * 8 + frag_col(lane, e)];
        x *= scale;
        if (masked && !visible(frag_row(lane, e), n * 8 + frag_col(lane, e)))
          x = NEG_BIG;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);  // masked: exactly 0
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // acc += P V, 16 keys a k-step. ldmatrix.trans of [key][d] rows gives
    // the B fragments of two 8-column blocks (matrices: keys 0-7 d 0-7,
    // keys 8-15 d 0-7, keys 0-7 d 8-15, keys 8-15 d 8-15).
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      // The A fragment of keys 16 kk .. 16 kk + 15: reg 2 j + i holds
      // elements 2 i, 2 i + 1 of the C fragment of 8-key block 2 kk + j.
      uint32_t a[4], mid[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 2 * kk + (r >> 1), e = 2 * (r & 1);
        if constexpr (Q8) {
          const int c = n * 8 + frag_col(lane, e);
          split3(s[n][e] * v_scale[c], s[n][e + 1] * v_scale[c + 1], a[r],
                 mid[r], lo[r]);
        } else {
          a[r] = pack_bf16(s[n][e], s[n][e + 1]);
        }
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(
            b, v_s + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld<D>() +
                   np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        if constexpr (Q8) {
          mma_bf16(acc[2 * np], mid, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], mid, b[2], b[3]);
          mma_bf16(acc[2 * np], lo, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
        }
      }
    }
  }
};

}  // namespace attn_mma
