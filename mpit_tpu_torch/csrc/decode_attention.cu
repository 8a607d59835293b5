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
// slot's fill are never read. K/V rows are staged through shared memory
// in chunks of KC keys as f32 (int8 rows dequantized on the way), with
// 16-byte loads that all issue at once, and the next chunk's loads are in
// flight (held in registers) while the current chunk is computed.
//
// Paged addressing: the slot's block-table row is staged in shared memory
// once per block, and the page is resolved per key row. A chunk of KC
// keys may straddle pages (page_size 16 is below KC), so unlike the TPU
// kernel, whose tiles never straddle a page, nothing here assumes that
// page_size is a multiple of the chunk or of block_k. Keys past the fill
// but inside n_k * block_k resolve through whatever the table holds there
// (zeroed or stale entries, pages below the pool's size, which the engine
// checks on its host table); they are masked to weight 0 and only their
// finiteness matters.
//
// Layout: grid (B, H, ceil(T / ROWS)), ROWS warps per block, one query row
// per warp. Lane j scores key j of the staged chunk; the PV product splits
// the head dimension over the lanes. Numerics follow the TPU kernel: q is
// taken to f32; products are summed in f32 and scaled by 1/sqrt(D);
// masked scores are -1e30; the running max, denominator and accumulator
// are f32; p is taken to V's storage dtype before the PV product, as
// p.astype(v.dtype): rounded for bf16 V, unrounded for f32 V and for int8
// V (dequantized to f32); o = acc / l with l == 0 -> 1, cast to q's
// dtype. K/V must start on a 16-byte boundary (the wrapper checks).
//
// C interface for ctypes: mpit_flash_decode (dense) and
// mpit_flash_paged_decode return the cudaError_t of the launch
// (cudaGetLastError right after it), or -1 for a dtype or head dimension
// this file was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

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

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *block_table, *lengths;
  void *o, *visited;
  int b, t, s_len, n_ps, h, d, block_k;
  float scale;
};

// s_len is the buffer length S (dense) or the page size (paged).
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

  const int s_max = PAGED ? n_ps * s_len : s_len;  // the slot's length
  const int length = lengths[b];
  const int n_k =
      min(max((length + t_q + block_k - 1) / block_k, 1), s_max / block_k);
  if (h == 0 && blockIdx.z == 0 && threadIdx.x == 0) visited[b] = n_k;
  const int k_end = n_k * block_k;
  const int q_pos = length + t;  // key j is visible iff j <= q_pos

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
  RowOf<PAGED> row_of;
  if constexpr (PAGED) {
    const int pages = (k_end + s_len - 1) / s_len;  // <= n_ps
    for (int i = threadIdx.x; i < pages; i += blockDim.x)
      bt_s[i] = block_table[(size_t)b * n_ps + i];
    row_of = RowOf<true>{bt_s, s_len};
  } else {
    row_of = RowOf<false>{(size_t)b * s_len};
  }
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

template <typename Q, typename KV, int D, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t static_smem =
      sizeof(float) * (ROWS * D + KC * (D + 1) + KC * D);
  const size_t dyn = PAGED ? sizeof(int) * (size_t)a.n_ps : 0;
  auto kernel = flash_decode_kernel<Q, KV, D, PAGED>;
  if (static_smem + dyn > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.b, a.h, (a.t + ROWS - 1) / ROWS);
  kernel<<<grid, NTHREADS, dyn, stream>>>(
      static_cast<const Q*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale),
      static_cast<const int*>(a.block_table),
      static_cast<const int*>(a.lengths), static_cast<Q*>(a.o),
      static_cast<int*>(a.visited), a.t, a.s_len, a.n_ps, a.h, a.block_k,
      a.scale);
  return cudaGetLastError();
}

template <typename Q, typename KV, bool PAGED>
int launch_d(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 16:
      return launch<Q, KV, 16, PAGED>(a, stream);
    case 32:
      return launch<Q, KV, 32, PAGED>(a, stream);
    case 64:
      return launch<Q, KV, 64, PAGED>(a, stream);
    case 128:
      return launch<Q, KV, 128, PAGED>(a, stream);
    default:
      return -1;
  }
}

// q_dtype: 0 = float32, 1 = bfloat16 (o shares it);
// kv_dtype: 0 = float32, 1 = bfloat16, 2 = int8 with f32 scales.
template <bool PAGED>
int dispatch(const Args& a, int q_dtype, int kv_dtype, cudaStream_t stream) {
  if (q_dtype == 0) {
    if (kv_dtype == 0) return launch_d<float, float, PAGED>(a, stream);
    if (kv_dtype == 1) return launch_d<float, __nv_bfloat16, PAGED>(a, stream);
    if (kv_dtype == 2) return launch_d<float, int8_t, PAGED>(a, stream);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) return launch_d<__nv_bfloat16, float, PAGED>(a, stream);
    if (kv_dtype == 1)
      return launch_d<__nv_bfloat16, __nv_bfloat16, PAGED>(a, stream);
    if (kv_dtype == 2) return launch_d<__nv_bfloat16, int8_t, PAGED>(a, stream);
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

const char* mpit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
