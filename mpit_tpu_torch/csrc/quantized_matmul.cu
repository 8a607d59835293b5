// Fused-dequant int8 matmul for Hopper (sm_90a): the int8 weight store's
// serving matmul.
//
// Replaces the TPU kernel mpit_tpu/ops/quantized_matmul.py::_qmm_kernel
// (called through _qmm_call).
//
// What it computes: o[M, F] = sum_k x[M, k] * (float(q[k, F]) * s[k]), with
// x f32 or bf16 [M, D] (a template axis; bf16 -> f32 is exact, so bf16 x is
// read as it is and converted in registers), q int8 [D, F] row-major, s f32
// [D] (one scale per contraction row) and o f32 [M, F]. Each weight
// dequantizes as the single f32 product float(q) * s, the product the plain
// version forms, so the dequantized values are bit-equal to it; products
// are summed in f32, in another order than the plain version's.
//
// What bounds it: at the decode width (M = 8 slots) device-memory bytes,
// the D * F int8 weight read once; at prefill widths (M = 512, 1024) the
// 2 * M * D * F operations, here on CUDA cores in f32 (no tensor cores).
// What the design does about it (a simple design, right first): threads lie
// along F, each loading 16 int8 weights of a row as one 16-byte load, so a
// warp reads whole 128-byte row segments; the next chunk's weight rows are
// in flight while the current chunk is computed; the contraction is split
// over 32 slices of a block so that a thread walks D / 32 rows, not D, and
// the slices' partial sums are reduced in a fixed order (deterministic). The
// BM rows of x for the current chunk are staged in shared memory as f32 and
// every dequantized weight is used for all BM rows. wgmma, TMA and a split
// across blocks are not used here.
//
// Layout: grid (ceil(F / BN), ceil(M / BM)), NTHREADS threads a block.
// Thread (tx, ks) owns columns n0 + 16 tx .. + 15 and the contraction rows
// k = ks, ks + KS, ... of each chunk of BK rows. Every tail is masked: rows
// of x past M and columns past D stage as 0, weight rows past D and columns
// past F load as 0, and outputs past M or F are not written. A row segment
// loads as one 16-byte vector where F is a multiple of 16 and q is 16-byte
// aligned, else byte by byte.
//
// C interface for ctypes: mpit_quantized_matmul returns the cudaError_t of
// the launch (cudaGetLastError right after it), or -1 for an x dtype this
// file was not instantiated for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int VEC = 16;               // int8 weights per load = columns a thread
constexpr int TX = 8;                 // threads along F
constexpr int BN = TX * VEC;          // 128 columns a block
constexpr int KS = 32;                // contraction slices a block
constexpr int NTHREADS = TX * KS;     // 256
constexpr int BM = 8;                 // rows of x a block (the wrapper's _BLOCK_M)
constexpr int R = 4;                  // weight rows a slice loads per chunk
constexpr int BK = KS * R;            // 128 contraction rows a chunk
constexpr int WARPS = NTHREADS / 32;  // 8; a warp holds 32 / TX = 4 slices

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 int8 weights of row k from column n, as four 32-bit words; zero past
// D and past F.
__device__ __forceinline__ int4 load_row16(const int8_t* __restrict__ q, int k,
                                           int n, int d, int f, bool vec_ok) {
  if (k >= d) return make_int4(0, 0, 0, 0);
  const int8_t* row = q + (size_t)k * f;
  if (vec_ok && n + VEC <= f) {
    return __ldg(reinterpret_cast<const int4*>(row + n));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (n + j < f) {
      w[j / 4] |= static_cast<unsigned>(static_cast<uint8_t>(row[n + j]))
                  << (8 * (j % 4));
    }
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}

// Byte b (0..3) of a 32-bit word as a signed int8, in f32.
__device__ __forceinline__ float byte_f32(int word, int b) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * b)) & 0xff));
}

template <typename X>
__global__ void __launch_bounds__(NTHREADS, 1)
    qmm_kernel(const X* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ s, float* __restrict__ o, int m,
               int d, int f, bool vec_ok) {
  __shared__ float x_s[BM][BK];
  __shared__ __align__(16) float part[WARPS][BM * BN];

  const int tx = threadIdx.x % TX;
  const int ks = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + tx * VEC;

  float acc[BM][VEC];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  }

  // The first chunk's weight rows and scales.
  int4 wv[R];
  float sv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = ks + KS * r;
    wv[r] = load_row16(q, k, n, d, f, vec_ok);
    sv[r] = k < d ? s[k] : 0.f;
  }

  for (int k0 = 0; k0 < d; k0 += BK) {
    // Stage x[m0 : m0 + BM, k0 : k0 + BK] as f32, zeros past M and D.
    for (int i = threadIdx.x; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      x_s[r][c] = (gm < m && gk < d) ? to_f32(x[(size_t)gm * d + gk]) : 0.f;
    }
    __syncthreads();
    int4 cur[R];
    float cur_s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      cur[r] = wv[r];
      cur_s[r] = sv[r];
    }
    // The next chunk's rows go in flight while this one is computed.
    if (k0 + BK < d) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = k0 + BK + ks + KS * r;
        wv[r] = load_row16(q, k, n, d, f, vec_ok);
        sv[r] = k < d ? s[k] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int words[4] = {cur[r].x, cur[r].y, cur[r].z, cur[r].w};
      float w[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        w[j] = byte_f32(words[j / 4], j % 4) * cur_s[r];
      }
      const int kk = ks + KS * r;
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float xv = x_s[i][kk];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Reduce the KS slices in a fixed order: the warp's four slices by a
  // butterfly (every lane ends with the same sum), then the warps' sums
  // through shared memory, warp 0 first.
#pragma unroll
  for (int i = 0; i < BM; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, TX);
      v += __shfl_xor_sync(0xffffffffu, v, 2 * TX);
      acc[i][j] = v;
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < TX) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(&part[warp][i * BN + tx * VEC + j]) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x * 4; e < BM * BN; e += NTHREADS * 4) {
    float4 sum = *reinterpret_cast<const float4*>(&part[0][e]);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(&part[w][e]);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    const int gm = m0 + e / BN;
    const int gn = n0 + e % BN;
    if (gm < m) {
      float* out = o + (size_t)gm * f;
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gn + c < f) out[gn + c] = vals[c];
      }
    }
  }
}

}  // namespace

extern "C" {

// x [m, d] (x_dtype 0 = float32, 1 = bfloat16), q [d, f] int8, s [d] f32,
// o [m, f] f32; all contiguous.
int mpit_quantized_matmul(const void* x, const void* q, const void* s, void* o,
                          int m, int d, int f, int x_dtype, void* stream) {
  const bool vec_ok =
      f % VEC == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((f + BN - 1) / BN, (m + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* op = static_cast<float*>(o);
  if (x_dtype == 0) {
    qmm_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), qp, sp, op, m, d, f, vec_ok);
  } else if (x_dtype == 1) {
    qmm_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, op, m, d, f, vec_ok);
  } else {
    return -1;
  }
  return cudaGetLastError();
}

const char* mpit_qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
