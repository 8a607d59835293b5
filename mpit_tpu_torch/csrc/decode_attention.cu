// Flash-decode attention for Hopper (sm_90a) against the serving engine's
// KV cache: dense per-slot buffers or a paged pool, K/V stored in f32,
// bf16, or int8 with one f32 scale per (row, head).
//
// Replaces the TPU kernel mpit_tpu/ops/decode_attention.py::_decode_kernel
// in all four of its forms: dense (_decode_call) and paged
// (_paged_decode_call), each plain or with fused dequantization
// (quantized=True). As there, one kernel body serves them all; here the
// addressing (PAGED) and the K/V storage type (KV) are template axes.
//
// What it computes: queries q [B, T, H, D] are the T newest positions of
// each slot (global position lengths[b] + t). Dense: k, v [B, S, H, D]
// with the new rows already written. Paged: k, v [P, page_size, H, D]
// pools, and key j of slot b is row (j % page_size) of page
// block_table[b, j / page_size]; the slot's virtual length is S =
// pages_per_slot * page_size. Key j is visible to query t iff
// j <= lengths[b] + t. int8 K/V come with scales [B, S, H] (dense) or
// [P, page_size, H] (paged), and a key row of head h dequantizes to
// float(q) * scale. The output o [B, T, H, D] has q's dtype, which may
// differ from K/V's. visited[b] is the number of block_k tiles the slot's
// loop covers: clamp(ceil((lengths[b] + T) / block_k), 1, S / block_k).
//
// What bounds it: device-memory bytes. A slot needs only its visited K and
// V rows (at 1 + 4 / D bytes per element for int8, scales included), plus
// q, o and its block-table row; the arithmetic is about 4 * T * D
// operations per visited key and head, far below the card's
// operations-per-byte balance. What the design does about it: every block
// reads lengths[b] itself and stops at key n_k * block_k, so rows past a
// slot's fill are never read; K/V rows move as 16-byte loads that all
// issue at once, and the next chunk's loads are in flight while the
// current chunk is computed (through cp.async in the split, mma and q8mma
// bodies; held in registers in the rows body, which stages its chunks of
// KC keys as f32, int8 rows dequantized on the way).
//
// Paged addressing: the slot's block-table row is staged in shared memory
// once per block, and the page is resolved per key row. A chunk of keys
// may straddle pages (page_size 16 is below KC), so unlike the TPU
// kernel, whose tiles never straddle a page, nothing here assumes that
// page_size is a multiple of the chunk or of block_k. Keys past the fill
// but inside n_k * block_k resolve through whatever the table holds there
// (zeroed or stale entries, pages below the pool's size, which the engine
// checks on its host table); they are masked to weight 0 and only their
// finiteness matters.
//
// Four bodies. Which one runs is a function of the dtypes and the query
// width alone: path_of below, exported as mpit_decode_path. The wrapper
// counts each launch by its answer and refuses a call where it parts from
// ops/decode_attention.py::_decode_path, the same rule on the host. All
// four share the per-slot bound, the visibility rule and the addressing
// (RowOf), so a paged call over an identity-mapped pool gives bit for bit
// what the dense call gives, body for body.
//
// - split (T = 1, every form: the decode tick). Grid (B, H), W = 4 warps.
//   The warps share the slot's visited keys: warp w takes the 32-key
//   chunks w, w + W, w + 2W, ..., each staged by cp.async into the warp's
//   own region of shared memory in its storage dtype (int8 rows with their
//   scales, dequantized as they are read), double-buffered where it fits,
//   synchronised with __syncwarp() alone. Each warp keeps its own (m, l,
//   acc); one merge through shared memory at the end gives m* = max m_w,
//   l = sum e^(m_w - m*) l_w, acc = sum e^(m_w - m*) acc_w (a warp that saw
//   no key, m_w = -1e30 and l_w = 0, adds exactly 0). W = 4 and not 8: at
//   f32 K/V and head dim 128 a warp's staged chunk is 33 KB, so eight warps
//   would not fit 227 KB even single-buffered; four warps keep every form
//   on one body (single-buffered only there) and already hold 4 x 2 chunks
//   in flight a slot.
// - mma (T > 1, q and K/V bf16: the prefills of the bf16 serving runs).
//   Grid (B, H, ceil(T / 64)), 4 warps: the tensor-core tile of
//   attn_mma.cuh over 64-key chunks, double-buffered through cp.async, so a
//   slot's K/V is read ceil(T / 64) times. Rows at or past the slot's
//   bound are zero-filled and masked.
// - q8mma (T > 1, bf16 q over int8 K/V: the prefills of the int8-K/V
//   serving runs). The mma body's kernel, grid and tile (one template over
//   the K/V type, mma_decode_kernel) over chunks of 64 int8 rows and their
//   scales, double-buffered through cp.async at a quarter of f32's bytes;
//   after each chunk lands the block converts its K and V rows to bf16
//   tiles (exact) and runs attn_mma.cuh's int8 step: the K scale on the f32
//   score, p times the V scale split into three bf16 pieces, so the PV
//   product sees p in f32, as the reference's f32 (dequantized) V does.
// - rows (T > 1 with an f32 operand: f32 q over any K/V, or f32 K/V).
//   Grid (B, H, ceil(T / ROWS)), ROWS warps per block, one query row per
//   warp; f32 operands need f32 products, so this body stays on f32 FMAs.
//
// Numerics follow the TPU kernel: q is taken to f32 (split, rows) or kept
// bf16 against bf16 K and exact bf16 copies of int8 K (mma, q8mma);
// products are summed in f32 and scaled by 1/sqrt(D) (after the K scale
// for int8); masked scores are -1e30; the running max, denominator and
// accumulator are f32; p is taken to V's storage dtype before the PV
// product, as p.astype(v.dtype): rounded for bf16 V, unrounded for f32 V
// and for int8 V (dequantized to f32; q8mma's three-piece split carries p
// times the V scale to within 2^-27 of itself); o = acc / l with l == 0 ->
// 1, cast to q's dtype. In the split and rows bodies lane j scores key j of
// the chunk (products summed in d order) and the PV product splits the head
// dimension over the lanes; the split body differs from the rows body only
// in the order of the sum over chunks. K/V must start on a 16-byte
// boundary (the wrapper checks).
//
// C interface for ctypes: mpit_flash_decode (dense) and
// mpit_flash_paged_decode return the cudaError_t of the launch
// (cudaGetLastError right after it), or -1 for a dtype or head dimension
// this file was not instantiated for. mpit_decode_path and
// mpit_decode_smem_bytes answer which body a call runs and the shared
// memory a block of it takes, launching nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;

constexpr int KC = 32;    // keys staged per chunk: one per lane
constexpr int ROWS = 4;   // query rows per block: one per warp
constexpr int NTHREADS = ROWS * 32;
constexpr float NEG_BIG = -1e30f;  // exp underflows to exactly 0 in f32
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // without the opt-in attribute

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

// p in V's storage dtype: rounded for bf16, unchanged for f32 and int8.
template <typename KV>
__device__ __forceinline__ float p_in_v(float p) {
  return p;
}
template <>
__device__ __forceinline__ float p_in_v<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Where key j of the block's slot lives: its row index into the K/V
// arrays (rows of H * D elements) and their scales (rows of H).
template <bool PAGED>
struct RowOf;
template <>
struct RowOf<false> {
  size_t base;  // b * S
  __device__ __forceinline__ size_t operator()(int key) const {
    return base + key;
  }
};
template <>
struct RowOf<true> {
  const int* bt;  // the slot's block-table row, in shared memory
  int ps;
  __device__ __forceinline__ size_t operator()(int key) const {
    return (size_t)bt[key / ps] * ps + key % ps;
  }
};

// One chunk of KC cache rows of one head, K and V, moved as 16-byte
// vectors: VPR vectors per row, each thread holding PER_THREAD of them
// (and, for int8, the scale of each vector's row).
template <typename KV, int D>
struct Chunk {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int VEC = 16 / sizeof(KV);  // elements per vector
  static constexpr int VPR = D / VEC;
  static constexpr int TOTAL = KC * VPR;
  static constexpr int PER_THREAD = (TOTAL + NTHREADS - 1) / NTHREADS;
  static_assert(D % VEC == 0, "a row must be whole 16-byte vectors");

  uint4 k[PER_THREAD], v[PER_THREAD];
  float ks[PER_THREAD], vs[PER_THREAD];

  // Issue the loads of keys c0 .. c0 + KC - 1 (keys at or past k_end read
  // as zeros); nothing waits on them until store(). k_h/v_h point at head
  // h of row 0, ks_h/vs_h at its scale; row is H * D, n_heads is H.
  template <bool PAGED>
  __device__ __forceinline__ void load(const KV* k_h, const KV* v_h,
                                       const float* ks_h, const float* vs_h,
                                       size_t row, int n_heads,
                                       const RowOf<PAGED>& row_of, int c0,
                                       int k_end) {
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = it * NTHREADS + threadIdx.x;
      const int key = c0 + i / VPR;
      k[it] = v[it] = make_uint4(0u, 0u, 0u, 0u);
      ks[it] = vs[it] = 0.f;
      if (i < TOTAL && key < k_end) {
        const size_t r = row_of(key);
        const size_t off = r * row + (i % VPR) * VEC;
        k[it] = *reinterpret_cast<const uint4*>(k_h + off);
        v[it] = *reinterpret_cast<const uint4*>(v_h + off);
        if constexpr (QUANT) {
          ks[it] = ks_h[r * n_heads];
          vs[it] = vs_h[r * n_heads];
        }
      }
    }
  }

  // Write the held rows to shared memory as f32 (int8 dequantized).
  __device__ __forceinline__ void store(float (*k_s)[D + 1],
                                        float (*v_s)[D]) const {
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = it * NTHREADS + threadIdx.x;
      if (i >= TOTAL) continue;
      const int j = i / VPR, d0 = (i % VPR) * VEC;
      KV kx[VEC], vx[VEC];
      memcpy(kx, &k[it], sizeof(kx));
      memcpy(vx, &v[it], sizeof(vx));
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (QUANT) {
          k_s[j][d0 + e] = to_f32(kx[e]) * ks[it];
          v_s[j][d0 + e] = to_f32(vx[e]) * vs[it];
        } else {
          k_s[j][d0 + e] = to_f32(kx[e]);
          v_s[j][d0 + e] = to_f32(vx[e]);
        }
      }
    }
  }
};

// The slot's bound, shared by every body: every block reads
// lengths[b] and stops at key k_end = n_k * block_k.
struct Bound {
  int length, n_k, k_end;
};
__device__ __forceinline__ Bound slot_bound(const int* lengths, int b,
                                            int t_q, int s_max, int block_k) {
  const int length = lengths[b];
  const int n_k =
      min(max((length + t_q + block_k - 1) / block_k, 1), s_max / block_k);
  return {length, n_k, n_k * block_k};
}

// Stage the pages of the slot's block-table row that hold keys below k_end.
template <bool PAGED>
__device__ __forceinline__ RowOf<PAGED> stage_row_of(const int* block_table,
                                                     int* bt_s, int b,
                                                     int s_len, int n_ps,
                                                     int k_end) {
  if constexpr (PAGED) {
    const int pages = (k_end + s_len - 1) / s_len;  // <= n_ps
    for (int i = threadIdx.x; i < pages; i += blockDim.x)
      bt_s[i] = block_table[(size_t)b * n_ps + i];
    return RowOf<true>{bt_s, s_len};
  } else {
    return RowOf<false>{(size_t)b * s_len};
  }
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *block_table, *lengths;
  void *o, *visited;
  int b, t, s_len, n_ps, h, d, block_k;
  float scale;
};

// The rows body. s_len is the buffer length S (dense) or the page size
// (paged), in every body.
template <typename Q, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths, Q* __restrict__ o,
                    int* __restrict__ visited, int t_q, int s_len, int n_ps,
                    int n_heads, int block_k, float scale) {
  constexpr int NACC = (D + 31) / 32;  // head-dim entries per lane
  extern __shared__ int bt_s[];       // paged: the slot's block-table row
  __shared__ float q_s[ROWS][D];
  __shared__ float k_s[KC][D + 1];  // +1: lane j reads row j, no conflicts
  __shared__ float v_s[KC][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.z * ROWS + warp;
  const bool row_ok = t < t_q;

  const Bound bd =
      slot_bound(lengths, b, t_q, PAGED ? n_ps * s_len : s_len, block_k);
  if (h == 0 && blockIdx.z == 0 && threadIdx.x == 0) visited[b] = bd.n_k;
  const int k_end = bd.k_end;
  const int q_pos = bd.length + t;  // key j is visible iff j <= q_pos

  const size_t row = (size_t)n_heads * D;  // one cache row, all heads
  const KV* k_h = k + (size_t)h * D;
  const KV* v_h = v + (size_t)h * D;
  const float* ks_h = Chunk<KV, D>::QUANT ? k_scale + h : nullptr;
  const float* vs_h = Chunk<KV, D>::QUANT ? v_scale + h : nullptr;

  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i % D, tr = blockIdx.z * ROWS + r;
    q_s[r][d] = tr < t_q
                    ? to_f32(q[(((size_t)b * t_q + tr) * n_heads + h) * D + d])
                    : 0.f;
  }
  const RowOf<PAGED> row_of =
      stage_row_of<PAGED>(block_table, bt_s, b, s_len, n_ps, k_end);
  __syncthreads();  // q_s and the block-table row are staged

  float m = NEG_BIG, l = 0.f, acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  Chunk<KV, D> chunk;
  chunk.load(k_h, v_h, ks_h, vs_h, row, n_heads, row_of, 0, k_end);
  for (int c0 = 0; c0 < k_end; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed
    chunk.store(k_s, v_s);
    __syncthreads();
    // The next chunk's loads run while this one is computed.
    if (c0 + KC < k_end)
      chunk.load(k_h, v_h, ks_h, vs_h, row, n_heads, row_of, c0 + KC, k_end);
    if (!row_ok) continue;

    const int key = c0 + lane;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(q_s[warp][d], k_s[lane][d], s);
    s = (key < k_end && key <= q_pos) ? s * scale : NEG_BIG;

    const float m_new = fmaxf(m, warp_max(s));
    const float p = expf(s - m_new);  // masked keys: exactly 0
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
    const float p_v = p_in_v<KV>(p);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int j = 0; j < KC; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p_v, j);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(pj, v_s[j][d], acc[i]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  // Key 0 is visible to every query, so l > 0; the guard only keeps a
  // malformed call finite, as in the TPU kernel.
  const float l_safe = l == 0.f ? 1.f : l;
  Q* o_row = o + (((size_t)b * t_q + t) * n_heads + h) * D;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o_row[d] = from_f32<Q>(acc[i] / l_safe);
  }
}

// Shared memory of the tensor-core bodies after the Q tile, block-table row
// aside, and how a chunk of 64 keys moves through it. mma (bf16 K/V): two
// stages, each a K and a V tile ([64][D + 8] bf16) that the step reads
// where the copies left them. q8mma (int8 K/V): the K and V tiles the step
// reads, then two stages, each the chunk's int8 K rows and V rows ([64][D]
// bytes, unpadded: the 16-byte copies and reads of consecutive threads fall
// on consecutive addresses) and their K and V scales (f32 [64] each); the
// block converts a stage into the tiles once it lands.
template <typename KV, int D>
struct MmaChunk {
  static constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  static constexpr int TILE = am::TILE_KEYS * am::ld<D>();  // elements
  static constexpr int ROWS_BYTES = am::TILE_KEYS * D;       // int8 rows
  static constexpr int STAGE =
      Q8 ? 2 * ROWS_BYTES + 2 * am::TILE_KEYS * 4 : 2 * TILE * 2;
  // Dynamic bytes: the Q tile, q8mma's converted tiles, two stages.
  static constexpr int BYTES = (Q8 ? 3 : 1) * TILE * 2 + 2 * STAGE;
  static_assert(D % 16 == 0, "an int8 row must be whole 16-byte vectors");
};

// A q8mma stage's int8 K and V rows as the bf16 tiles kb and vb (exact),
// 16 values a thread and pass.
template <int D>
__device__ __forceinline__ void convert_q8(const unsigned char* st,
                                           __nv_bfloat16* kb,
                                           __nv_bfloat16* vb) {
  constexpr int VPR = D / 16;  // 16-byte vectors of an int8 row
  constexpr int ROWS_BYTES = MmaChunk<int8_t, D>::ROWS_BYTES;
  for (int i = threadIdx.x; i < 2 * am::TILE_KEYS * VPR; i += am::THREADS) {
    const int m = i / (am::TILE_KEYS * VPR), j = i % (am::TILE_KEYS * VPR);
    const int r = j / VPR, c = (j % VPR) * 16;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(st + m * ROWS_BYTES + r * D + c);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {  // values 2 e, 2 e + 1 of the 16
      const uint32_t pair = w[e >> 1] >> ((e & 1) * 16);
      out[e] = am::pack_bf16(static_cast<float>(static_cast<int8_t>(pair)),
                             static_cast<float>(static_cast<int8_t>(pair >> 8)));
    }
    uint4* dst = reinterpret_cast<uint4*>((m ? vb : kb) + r * am::ld<D>() + c);
    dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
    dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// The tensor-core bodies, bf16 q at T > 1: mma over bf16 K/V (KV =
// __nv_bfloat16; k_scale, v_scale unused) and q8mma over int8 K/V with f32
// scales (KV = int8_t). Dynamic shared memory: MmaChunk<KV, D>::BYTES, then
// the slot's block-table row (paged).
template <typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(am::THREADS, am::min_blocks<D>())
mma_decode_kernel(const __nv_bfloat16* __restrict__ q,
                  const KV* __restrict__ k, const KV* __restrict__ v,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ block_table,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ o, int* __restrict__ visited,
                  int t_q, int s_len, int n_ps, int n_heads, int block_k,
                  float scale) {
  using Ch = MmaChunk<KV, D>;
  constexpr bool Q8 = Ch::Q8;
  extern __shared__ uint4 mma_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(mma_smem);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kb = qs + Ch::TILE;  // q8mma: the chunk's K, as bf16
  __nv_bfloat16* vb = kb + Ch::TILE;  // and its V
  unsigned char* stages = smem + (Q8 ? 3 : 1) * Ch::TILE * 2;
  int* bt_s = reinterpret_cast<int*>(smem + Ch::BYTES);

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.z * am::TILE_ROWS + warp * 16;  // the warp's slab
  const Bound bd =
      slot_bound(lengths, b, t_q, PAGED ? n_ps * s_len : s_len, block_k);
  if (h == 0 && blockIdx.z == 0 && threadIdx.x == 0) visited[b] = bd.n_k;

  const size_t row = (size_t)n_heads * D;  // one cache row, all heads
  const KV* k_h = k + (size_t)h * D;
  const KV* v_h = v + (size_t)h * D;
  const __nv_bfloat16* q_h = q + ((size_t)b * t_q * n_heads + h) * D;
  const RowOf<PAGED> row_of =
      stage_row_of<PAGED>(block_table, bt_s, b, s_len, n_ps, bd.k_end);
  __syncthreads();  // the block-table row is staged

  const int qr0 = blockIdx.z * am::TILE_ROWS;
  am::stage_rows<D>(qs, q_h, [&](int r) -> const __nv_bfloat16* {
    return qr0 + r < t_q ? q_h + (size_t)(qr0 + r) * row : nullptr;
  });
  // Keys c0 .. c0 + 63 into stage st; keys at or past k_end (and their
  // scales) are zero-filled.
  auto stage_kv = [&](int c0, unsigned char* st) {
    if constexpr (Q8) {
      constexpr int VPR = D / 16;
      for (int i = threadIdx.x; i < am::TILE_KEYS * VPR; i += am::THREADS) {
        const int r = i / VPR, c = (i % VPR) * 16;
        const bool ok = c0 + r < bd.k_end;
        const size_t off = ok ? row_of(c0 + r) * row + c : 0;
        am::cp_async16(st + r * D + c, k_h + off, ok);
        am::cp_async16(st + Ch::ROWS_BYTES + r * D + c, v_h + off, ok);
      }
      static_assert(am::THREADS == 2 * am::TILE_KEYS, "one scale a thread");
      const int r = threadIdx.x % am::TILE_KEYS;
      const bool ok = c0 + r < bd.k_end;
      const size_t at = ok ? row_of(c0 + r) * n_heads + h : 0;
      float* sc = reinterpret_cast<float*>(st + 2 * Ch::ROWS_BYTES);
      if (threadIdx.x < am::TILE_KEYS)
        am::cp_async4(sc + r, k_scale + at, ok);
      else
        am::cp_async4(sc + am::TILE_KEYS + r, v_scale + at, ok);
    } else {
      auto key_row = [&](const __nv_bfloat16* base) {
        return [=](int r) -> const __nv_bfloat16* {
          return c0 + r < bd.k_end ? base + row_of(c0 + r) * row : nullptr;
        };
      };
      __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(st);
      am::stage_rows<D>(kt, k_h, key_row(k_h));
      am::stage_rows<D>(kt + Ch::TILE, v_h, key_row(v_h));
    }
  };
  stage_kv(0, stages);
  am::cp_async_commit();

  am::Rows16<D> tile;
  tile.init();
  const int n_chunks = (bd.k_end + am::TILE_KEYS - 1) / am::TILE_KEYS;
  for (int kc = 0; kc < n_chunks; ++kc) {
    unsigned char* st = stages + (kc & 1) * Ch::STAGE;
    am::cp_async_wait<0>();  // chunk kc (and, at kc 0, the Q tile) landed
    // ... and every warp is done with chunk kc - 1: its stage, the one the
    // next copies fill, and q8mma's bf16 tiles.
    __syncthreads();
    if (kc + 1 < n_chunks)
      stage_kv((kc + 1) * am::TILE_KEYS, stages + ((kc + 1) & 1) * Ch::STAGE);
    am::cp_async_commit();
    const __nv_bfloat16* k_t = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* v_t = k_t + Ch::TILE;
    const float* sc = reinterpret_cast<const float*>(st + 2 * Ch::ROWS_BYTES);
    if constexpr (Q8) {
      convert_q8<D>(st, kb, vb);
      k_t = kb;
      v_t = vb;
      __syncthreads();
    }
    if (kc == 0) tile.load_q(qs + warp * 16 * am::ld<D>());
    const int c0 = kc * am::TILE_KEYS;
    // Key j is visible to query t iff j <= length + t (and j < k_end).
    const bool masked = c0 + am::TILE_KEYS > bd.k_end ||
                        c0 + am::TILE_KEYS - 1 > bd.length + t0;
    tile.template step<Q8>(
        k_t, v_t, scale, masked,
        [&](int r, int c) {
          const int key = c0 + c;
          return key < bd.k_end && key <= bd.length + t0 + r;
        },
        sc, sc + am::TILE_KEYS);
  }
  am::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t0 + (lane >> 2) + 8 * i;
    if (t >= t_q) continue;
    // Key 0 is visible to every query, so l > 0; the guard only keeps a
    // malformed call finite, as in the TPU kernel.
    const float l_safe = tile.l[i] == 0.f ? 1.f : tile.l[i];
    __nv_bfloat16* o_row = o + (((size_t)b * t_q + t) * n_heads + h) * D;
#pragma unroll
    for (int n = 0; n < am::Rows16<D>::ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o_row + n * 8 + ((lane & 3) << 1)) =
          __floats2bfloat162_rn(tile.acc[n][2 * i] / l_safe,
                                tile.acc[n][2 * i + 1] / l_safe);
  }
}

constexpr int SPLIT_WARPS = 4;  // W of the split body (see the note above)
constexpr int SPLIT_THREADS = SPLIT_WARPS * 32;
constexpr int SPLIT_DOUBLE_MAX = 192 * 1024;  // double-buffer below this

// One warp's staged chunk of KC keys in the split body: K rows, V rows
// (storage dtype, each row padded by 16 bytes so that lane j's 16-byte
// reads of row j fall in distinct banks), then for int8 the K and V scales.
template <typename KV, int D>
struct SplitStage {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int VEC = 16 / sizeof(KV);  // elements a 16-byte vector
  static constexpr int VPR = D / VEC;           // vectors a row
  static constexpr int ROW = D * (int)sizeof(KV) + 16;  // bytes a row
  static constexpr int BYTES = 2 * KC * ROW + (QUANT ? 2 * KC * 4 : 0);
  static constexpr int STAGES =
      SPLIT_WARPS * 2 * BYTES <= SPLIT_DOUBLE_MAX ? 2 : 1;
  static constexpr int SMEM = SPLIT_WARPS * STAGES * BYTES;  // dynamic
  static_assert(D % VEC == 0, "a row must be whole 16-byte vectors");
};

// The split body: T = 1, every form. Dynamic shared memory: each warp's
// stages, then the slot's block-table row (paged).
template <typename Q, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_table,
                    const int* __restrict__ lengths, Q* __restrict__ o,
                    int* __restrict__ visited, int s_len, int n_ps,
                    int n_heads, int block_k, float scale) {
  using St = SplitStage<KV, D>;
  constexpr int NACC = (D + 31) / 32;  // head-dim entries per lane
  extern __shared__ uint4 split_smem[];
  __shared__ float q_s[D];
  __shared__ float acc_s[SPLIT_WARPS][D];
  __shared__ float m_s[SPLIT_WARPS], l_s[SPLIT_WARPS];
  unsigned char* mine = reinterpret_cast<unsigned char*>(split_smem) +
                        (threadIdx.x >> 5) * St::STAGES * St::BYTES;
  int* bt_s = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(split_smem) + St::SMEM);

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Bound bd =
      slot_bound(lengths, b, 1, PAGED ? n_ps * s_len : s_len, block_k);
  if (h == 0 && threadIdx.x == 0) visited[b] = bd.n_k;

  const size_t row = (size_t)n_heads * D;  // one cache row, all heads
  const KV* k_h = k + (size_t)h * D;
  const KV* v_h = v + (size_t)h * D;
  const float* ks_h = St::QUANT ? k_scale + h : nullptr;
  const float* vs_h = St::QUANT ? v_scale + h : nullptr;
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS)
    q_s[d] = to_f32(q[((size_t)b * n_heads + h) * D + d]);
  const RowOf<PAGED> row_of =
      stage_row_of<PAGED>(block_table, bt_s, b, s_len, n_ps, bd.k_end);
  __syncthreads();  // q_s and the block-table row are staged

  // This warp's copies of keys c0 .. c0 + KC - 1 into stage st (keys at or
  // past k_end zero-filled).
  auto issue = [&](unsigned char* st, int c0) {
#pragma unroll
    for (int it = 0; it < St::VPR; ++it) {
      const int i = it * 32 + lane;
      const int r = i / St::VPR, c = i % St::VPR;
      const bool ok = c0 + r < bd.k_end;
      const size_t off = ok ? row_of(c0 + r) * row + (size_t)c * St::VEC : 0;
      am::cp_async16(st + r * St::ROW + c * 16, k_h + off, ok);
      am::cp_async16(st + (KC + r) * St::ROW + c * 16, v_h + off, ok);
    }
    if constexpr (St::QUANT) {
      const bool ok = c0 + lane < bd.k_end;
      const size_t r = ok ? row_of(c0 + lane) : 0;
      float* sc = reinterpret_cast<float*>(st + 2 * KC * St::ROW);
      am::cp_async4(sc + lane, ks_h + r * n_heads, ok);
      am::cp_async4(sc + KC + lane, vs_h + r * n_heads, ok);
    }
  };

  float m = NEG_BIG, l = 0.f, acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int n_chunks = (bd.k_end + KC - 1) / KC;
  int c = warp;
  if (c < n_chunks) issue(mine, c * KC);
  am::cp_async_commit();
  for (int it = 0; c < n_chunks; ++it, c += SPLIT_WARPS) {
    const unsigned char* st = mine + (St::STAGES == 2 ? (it & 1) : 0) * St::BYTES;
    if constexpr (St::STAGES == 2) {
      // The warp's next chunk is in flight while this one is computed.
      if (c + SPLIT_WARPS < n_chunks)
        issue(mine + ((it + 1) & 1) * St::BYTES, (c + SPLIT_WARPS) * KC);
      am::cp_async_commit();
      am::cp_async_wait<1>();
    } else {
      am::cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this chunk are visible

    const int key = c * KC + lane;
    const KV* k_row = reinterpret_cast<const KV*>(st + lane * St::ROW);
    const float* sc = reinterpret_cast<const float*>(st + 2 * KC * St::ROW);
    float s = 0.f;
#pragma unroll
    for (int vi = 0; vi < St::VPR; ++vi) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k_row + vi * St::VEC);
      KV x[St::VEC];
      memcpy(x, &raw, sizeof(x));
#pragma unroll
      for (int e = 0; e < St::VEC; ++e) {
        float kd = to_f32(x[e]);
        if constexpr (St::QUANT) kd = kd * sc[lane];
        s = fmaf(q_s[vi * St::VEC + e], kd, s);
      }
    }
    const bool ok = key < bd.k_end && key <= bd.length;  // q_pos = length
    s = ok ? s * scale : NEG_BIG;
    const float m_new = fmaxf(m, warp_max(s));
    // Masked keys weigh exactly 0, also in a warp that has seen no key.
    const float p = ok ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
    const float p_v = p_in_v<KV>(p);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha;
    const unsigned char* v_rows = st + KC * St::ROW;
#pragma unroll 8
    for (int j = 0; j < KC; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p_v, j);
      const KV* v_row = reinterpret_cast<const KV*>(v_rows + j * St::ROW);
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float vd = to_f32(v_row[d]);
          if constexpr (St::QUANT) vd = vd * sc[KC + j];
          acc[i] = fmaf(pj, vd, acc[i]);
        }
      }
    }
    m = m_new;
    __syncwarp();  // the chunk is consumed before its stage is refilled
    if constexpr (St::STAGES == 1) {
      if (c + SPLIT_WARPS < n_chunks) issue(mine, (c + SPLIT_WARPS) * KC);
      am::cp_async_commit();
    }
  }
  am::cp_async_wait<0>();

  // Merge the warps' partial results.
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int d = lane + 32 * i;
    if (d < D) acc_s[warp][d] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) {
    float m_all = m_s[0];
#pragma unroll
    for (int w = 1; w < SPLIT_WARPS; ++w) m_all = fmaxf(m_all, m_s[w]);
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float e = expf(m_s[w] - m_all);
      l_all += e * l_s[w];
      a += e * acc_s[w][d];
    }
    // Key 0 is visible, so l > 0; the guard keeps a malformed call finite.
    const float l_safe = l_all == 0.f ? 1.f : l_all;
    o[((size_t)b * n_heads + h) * D + d] = from_f32<Q>(a / l_safe);
  }
}

enum Path { PATH_ROWS, PATH_MMA, PATH_SPLIT, PATH_Q8MMA };

// Which body a call runs: the same rule as ops/decode_attention.py::
// _decode_path. q_dtype / kv_dtype codes as in dispatch below.
Path path_of(int q_dtype, int kv_dtype, int t) {
  if (t == 1) return PATH_SPLIT;
  if (q_dtype == 1 && kv_dtype == 1) return PATH_MMA;
  if (q_dtype == 1 && kv_dtype == 2) return PATH_Q8MMA;
  return PATH_ROWS;
}

// Launch with `dyn` bytes of dynamic shared memory, opting in above the
// default when static + dynamic exceed it. With smem_out set, launch
// nothing and store the shared memory a block takes instead: the compiled
// kernel's static allocation plus `dyn`.
template <typename Kernel, typename... KArgs>
cudaError_t start(Kernel kernel, size_t static_smem, size_t dyn, dim3 grid,
                  int threads, cudaStream_t stream, size_t* smem_out,
                  KArgs... args) {
  if (smem_out) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    *smem_out = attr.sharedSizeBytes + dyn;
    return err;
  }
  if (static_smem + dyn > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, dyn, stream>>>(args...);
  return cudaGetLastError();
}

template <typename Q, typename KV, int D, bool PAGED>
cudaError_t launch(const Args& a, Path path, cudaStream_t stream,
                   size_t* smem_out) {
  const size_t bt = PAGED ? sizeof(int) * (size_t)a.n_ps : 0;
  const Q* q = static_cast<const Q*>(a.q);
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const float* ks = static_cast<const float*>(a.k_scale);
  const float* vs = static_cast<const float*>(a.v_scale);
  const int* table = static_cast<const int*>(a.block_table);
  const int* lengths = static_cast<const int*>(a.lengths);
  Q* o = static_cast<Q*>(a.o);
  int* visited = static_cast<int*>(a.visited);
  if (path == PATH_SPLIT) {
    using St = SplitStage<KV, D>;
    constexpr size_t static_smem =
        sizeof(float) * (D + SPLIT_WARPS * D + 2 * SPLIT_WARPS);
    return start(split_decode_kernel<Q, KV, D, PAGED>, static_smem,
                 St::SMEM + bt, dim3(a.b, a.h, 1), SPLIT_THREADS, stream,
                 smem_out, q, k, v, ks, vs, table, lengths, o, visited,
                 a.s_len, a.n_ps, a.h, a.block_k, a.scale);
  }
  // At T > 1 the dtypes alone pick the body (path_of), so each pair of
  // dtypes compiles only its own.
  constexpr bool BF16_Q = std::is_same<Q, __nv_bfloat16>::value;
  if constexpr (BF16_Q && !std::is_same<KV, float>::value) {  // mma, q8mma
    return start(mma_decode_kernel<KV, D, PAGED>, 0,
                 MmaChunk<KV, D>::BYTES + bt,
                 dim3(a.b, a.h, (a.t + am::TILE_ROWS - 1) / am::TILE_ROWS),
                 am::THREADS, stream, smem_out, q, k, v, ks, vs, table,
                 lengths, o, visited, a.t, a.s_len, a.n_ps, a.h, a.block_k,
                 a.scale);
  } else {
    constexpr size_t static_smem =
        sizeof(float) * (ROWS * D + KC * (D + 1) + KC * D);
    return start(flash_decode_kernel<Q, KV, D, PAGED>, static_smem, bt,
                 dim3(a.b, a.h, (a.t + ROWS - 1) / ROWS), NTHREADS, stream,
                 smem_out, q, k, v, ks, vs, table, lengths, o, visited, a.t,
                 a.s_len, a.n_ps, a.h, a.block_k, a.scale);
  }
}

template <typename Q, typename KV, bool PAGED>
int launch_d(const Args& a, Path path, cudaStream_t stream,
             size_t* smem_out) {
  switch (a.d) {
    case 16:
      return launch<Q, KV, 16, PAGED>(a, path, stream, smem_out);
    case 32:
      return launch<Q, KV, 32, PAGED>(a, path, stream, smem_out);
    case 64:
      return launch<Q, KV, 64, PAGED>(a, path, stream, smem_out);
    case 128:
      return launch<Q, KV, 128, PAGED>(a, path, stream, smem_out);
    default:
      return -1;
  }
}

// q_dtype: 0 = float32, 1 = bfloat16 (o shares it);
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 with f32 scales.
template <bool PAGED>
int dispatch(const Args& a, int q_dtype, int kv_dtype, cudaStream_t stream,
             size_t* smem_out = nullptr) {
  const Path p = path_of(q_dtype, kv_dtype, a.t);
  cudaStream_t s = stream;
  size_t* out = smem_out;
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_d<float, float, PAGED>(a, p, s, out);
    if (kv_dtype == 1)
      return launch_d<float, __nv_bfloat16, PAGED>(a, p, s, out);
    if (kv_dtype == 2) return launch_d<float, int8_t, PAGED>(a, p, s, out);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0)
      return launch_d<__nv_bfloat16, float, PAGED>(a, p, s, out);
    if (kv_dtype == 1)
      return launch_d<__nv_bfloat16, __nv_bfloat16, PAGED>(a, p, s, out);
    if (kv_dtype == 2)
      return launch_d<__nv_bfloat16, int8_t, PAGED>(a, p, s, out);
  }
  return -1;
}

}  // namespace

extern "C" {

// Dense: k, v [B, S, H, D]; k_scale, v_scale [B, S, H] for int8, else null.
int mpit_flash_decode(const void* q, const void* k, const void* v,
                      const void* k_scale, const void* v_scale,
                      const void* lengths, void* o, void* visited, int b,
                      int t, int s, int h, int d, int block_k, float scale,
                      int q_dtype, int kv_dtype, void* stream) {
  const Args a{q, k, v, k_scale, v_scale, nullptr, lengths, o, visited,
               b, t, s, 0, h, d, block_k, scale};
  return dispatch<false>(a, q_dtype, kv_dtype,
                         static_cast<cudaStream_t>(stream));
}

// Paged: k, v [P, page_size, H, D]; k_scale, v_scale [P, page_size, H] for
// int8, else null; block_table [B, pages_per_slot] int32.
int mpit_flash_paged_decode(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* block_table, const void* lengths,
                            void* o, void* visited, int b, int t,
                            int page_size, int pages_per_slot, int h, int d,
                            int block_k, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  const Args a{q,       k,         v,       k_scale,        v_scale,
               block_table,       lengths, o,              visited,
               b,       t,         page_size,               pages_per_slot,
               h,       d,         block_k, scale};
  return dispatch<true>(a, q_dtype, kv_dtype,
                        static_cast<cudaStream_t>(stream));
}

// The body a call with these dtype codes and query width runs: 0 rows,
// 1 mma, 2 split, 3 q8mma. The wrapper counts its launches by this answer.
int mpit_decode_path(int q_dtype, int kv_dtype, int t) {
  return path_of(q_dtype, kv_dtype, t);
}

// Shared memory, static and dynamic, that a block of that body takes at
// head dim d with a block-table row of pages_per_slot pages (0: dense), from
// the compiled kernel's attributes; -1 for what this file does not take.
int mpit_decode_smem_bytes(int q_dtype, int kv_dtype, int t, int d,
                           int pages_per_slot) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, 1, t, 1, pages_per_slot, 1, d,
               1, 1.f};
  size_t bytes = 0;
  const int err =
      pages_per_slot ? dispatch<true>(a, q_dtype, kv_dtype, nullptr, &bytes)
                     : dispatch<false>(a, q_dtype, kv_dtype, nullptr, &bytes);
  return err ? -1 : static_cast<int>(bytes);
}

const char* mpit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
