// Flash-decode attention for Hopper (sm_90a) against the dense per-slot
// KV cache of the serving engine.
//
// Replaces the TPU kernel mpit_tpu/ops/decode_attention.py::_decode_kernel
// in its dense, unquantized form (the one _decode_call launches).
//
// What it computes: queries q [B, T, H, D] are the T newest positions of
// each slot (global position lengths[b] + t); k, v [B, S, H, D] are the
// padded cache buffers with the new rows already written. Key j is
// visible to query t iff j <= lengths[b] + t. The output o [B, T, H, D]
// has q's dtype. visited[b] is the number of block_k tiles the slot's loop
// covers: clamp(ceil((lengths[b] + T) / block_k), 1, S / block_k).
//
// What bounds it: device-memory bytes. A slot needs only its visited K and
// V tiles, 2 * n_k * block_k * H * D * sizeof(T) bytes, plus q and o; the
// arithmetic is about 4 * T * D operations per visited key and head, far
// below the card's operations-per-byte balance for the T of a decode tick
// or a padded prefill. What the design does about it: every block reads
// lengths[b] itself and stops at key n_k * block_k, so tiles past a slot's
// fill are never read. K/V rows are staged through shared memory in chunks
// of KC keys, with 16-byte loads that all issue at once, and the next
// chunk's loads are in flight (held in registers) while the current chunk
// is computed. cp.async/TMA pipelining, splitting a slot's keys across
// blocks, and sharing one staged chunk across more query rows are later
// work.
//
// Layout: grid (B, H, ceil(T / ROWS)), ROWS warps per block, one query row
// per warp. Lane j scores key j of the staged chunk; the PV product splits
// the head dimension over the lanes. Numerics follow the TPU kernel: the
// products of input-dtype operands are summed in f32 and scaled by
// 1/sqrt(D); masked scores are -1e30; the running max, denominator and
// accumulator are f32; p is rounded to V's dtype before the PV product;
// o = acc / l with l == 0 -> 1, cast to q's dtype. k and v must start on
// a 16-byte boundary (the wrapper checks).
//
// C interface for ctypes: mpit_flash_decode returns the cudaError_t of the
// launch (cudaGetLastError right after it), or -1 for a dtype or head
// dimension this file was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int KC = 32;    // keys staged per chunk: one per lane
constexpr int ROWS = 4;   // query rows per block: one per warp
constexpr int NTHREADS = ROWS * 32;
constexpr float NEG_BIG = -1e30f;  // exp underflows to exactly 0 in f32

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

// One chunk of KC cache rows of one head, K and V, moved as 16-byte
// vectors: VPR vectors per row, each thread holding PER_THREAD of them.
template <typename T, int D>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(T);  // elements per vector
  static constexpr int VPR = D / VEC;
  static constexpr int TOTAL = KC * VPR;
  static constexpr int PER_THREAD = (TOTAL + NTHREADS - 1) / NTHREADS;
  static_assert(D % VEC == 0, "a row must be whole 16-byte vectors");

  uint4 k[PER_THREAD], v[PER_THREAD];

  // Issue the loads of rows c0 .. c0 + KC - 1 (rows at or past k_end
  // read as zeros); nothing waits on them until store().
  __device__ __forceinline__ void load(const T* k_bh, const T* v_bh,
                                       size_t row, int c0, int k_end) {
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = it * NTHREADS + threadIdx.x;
      const int key = c0 + i / VPR;
      const size_t off = (size_t)key * row + (i % VPR) * VEC;
      k[it] = v[it] = make_uint4(0u, 0u, 0u, 0u);
      if (i < TOTAL && key < k_end) {
        k[it] = *reinterpret_cast<const uint4*>(k_bh + off);
        v[it] = *reinterpret_cast<const uint4*>(v_bh + off);
      }
    }
  }

  // Write the held rows to shared memory as f32.
  __device__ __forceinline__ void store(float (*k_s)[D + 1],
                                        float (*v_s)[D]) const {
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = it * NTHREADS + threadIdx.x;
      if (i >= TOTAL) continue;
      const int j = i / VPR, d0 = (i % VPR) * VEC;
      T kx[VEC], vx[VEC];
      memcpy(kx, &k[it], sizeof(kx));
      memcpy(vx, &v[it], sizeof(vx));
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[j][d0 + e] = to_f32(kx[e]);
        v_s[j][d0 + e] = to_f32(vx[e]);
      }
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, int* __restrict__ visited, int t_q,
                    int s_max, int n_heads, int block_k, float scale) {
  constexpr int NACC = (D + 31) / 32;  // head-dim entries per lane
  __shared__ float q_s[ROWS][D];
  __shared__ float k_s[KC][D + 1];  // +1: lane j reads row j, no conflicts
  __shared__ float v_s[KC][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.z * ROWS + warp;
  const bool row_ok = t < t_q;

  const int length = lengths[b];
  const int n_k =
      min(max((length + t_q + block_k - 1) / block_k, 1), s_max / block_k);
  if (h == 0 && blockIdx.z == 0 && threadIdx.x == 0) visited[b] = n_k;
  const int k_end = n_k * block_k;
  const int q_pos = length + t;  // key j is visible iff j <= q_pos

  const size_t row = (size_t)n_heads * D;  // one cache row, all heads
  const T* k_bh = k + (size_t)b * s_max * row + (size_t)h * D;
  const T* v_bh = v + (size_t)b * s_max * row + (size_t)h * D;

  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, d = i % D, tr = blockIdx.z * ROWS + r;
    q_s[r][d] = tr < t_q
                    ? to_f32(q[(((size_t)b * t_q + tr) * n_heads + h) * D + d])
                    : 0.f;
  }

  float m = NEG_BIG, l = 0.f, acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  Chunk<T, D> chunk;
  chunk.load(k_bh, v_bh, row, 0, k_end);
  for (int c0 = 0; c0 < k_end; c0 += KC) {
    __syncthreads();  // the previous chunk is consumed; q_s is staged
    chunk.store(k_s, v_s);
    __syncthreads();
    // The next chunk's loads run while this one is computed.
    if (c0 + KC < k_end) chunk.load(k_bh, v_bh, row, c0 + KC, k_end);
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
    const float p_v = to_f32(from_f32<T>(p));  // p in V's dtype
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
  T* o_row = o + (((size_t)b * t_q + t) * n_heads + h) * D;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o_row[d] = from_f32<T>(acc[i] / l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, void* visited, int b, int t,
                   int s, int h, int block_k, float scale,
                   cudaStream_t stream) {
  const dim3 grid(b, h, (t + ROWS - 1) / ROWS);
  flash_decode_kernel<T, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), static_cast<int*>(visited), t, s, h, block_k,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v,
              const void* lengths, void* o, void* visited, int b, int t,
              int s, int h, int d, int block_k, float scale,
              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, o, visited, b, t, s, h, block_k,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, visited, b, t, s, h, block_k,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, visited, b, t, s, h, block_k,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, visited, b, t, s, h,
                            block_k, scale, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
int mpit_flash_decode(const void* q, const void* k, const void* v,
                      const void* lengths, void* o, void* visited, int b,
                      int t, int s, int h, int d, int block_k, float scale,
                      int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, lengths, o, visited, b, t, s, h, d,
                            block_k, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, lengths, o, visited, b, t, s, h,
                                    d, block_k, scale, st);
  return -1;
}

const char* mpit_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
