// Fused-dequant int8 matmul for Hopper (sm_90a): the int8 weight store's
// serving matmul.
//
// Replaces the TPU kernel mpit_tpu/ops/quantized_matmul.py::_qmm_kernel
// (called through _qmm_call).
//
// What it computes: o[M, F] = sum_k x[M, k] * (float(q[k, F]) * s[k]), with
// x f32 or bf16 [M, D], q int8 [D, F] row-major, s f32 [D] (one scale per
// contraction row) and o f32 [M, F]. Each weight dequantizes as the single
// f32 product float(q) * s (__fmul_rn), the product the plain version
// forms, so the dequantized values are bit-equal to it; products are
// summed in f32, in another order than the plain version's.
//
// Two bodies, named by plan_of (exported as mpit_qmm_plan, from which the
// launch takes its plan and by whose answer the wrapper counts launches):
//
// mma (bf16 x): the tensor cores. Each dequantized weight w (24 significant
// bits) is split into three bf16 pieces, hi = bf16(w), mid = bf16(w - hi),
// lo = bf16(w - hi - mid), each rounded to nearest even (attn_mma::split3);
// both subtractions are exact in f32 and each piece takes 8 of the 24 bits,
// so hi + mid + lo == w exactly (bf16 underflow, below 1e-38, aside). x is
// bf16, so every x * piece product is exact in f32, and
//   o = sum_k x hi + sum_k x mid + sum_k x lo
// runs as three mma.sync m16n8k16 bf16 -> f32 products into one f32
// accumulator: the dequantized weights are the plain version's, only the
// order of the f32 sums differs. Per contraction tile of BK = 32 rows,
// cp.async stages the int8 tile [BK, BN], its BK scales and the x tile
// [BM, BK] (a STAGES-deep ring, zero-filled past M, D and F); the block's
// threads then dequantize and split the int8 tile once into three bf16
// tiles [BK][BN + 8] (the padding puts the 8 rows of an ldmatrix 8 x 8
// matrix in distinct banks), shared by all BM rows of x: the weight is
// dequantized once per BM rows, not once per 8. The piece tiles are double
// buffered: while the warps multiply tile t they also split tile t + 1,
// with one barrier a tile, so one warp's dequantization overlaps another's
// mma. A-fragments come from the x tile by ldmatrix, B-fragments from the
// three piece tiles by ldmatrix.trans (the weight is [k][n], as V is in
// attention). Warp w owns a (BM / WM) x (BN / WN) sub-tile of the output.
//
// fma (f32 x): f32 FMAs on the CUDA cores, as before (f32 products would
// need six bf16 pieces; the f32 parity phases keep exact f32 arithmetic).
// Threads lie along F, each loading 16 int8 weights of a row as one
// 16-byte load; a block covers BM = 8 rows of x and 128 columns, its 256
// threads split the contraction into 32 slices whose partial sums are
// reduced in a fixed order through shared memory.
//
// What bounds it: at the decode width (M 8) the D * F int8 weight's bytes;
// at prefill widths (M 512, 1024) the tensor cores' rate for the 3 x 2 M D
// F bf16 operations. The tiles (plan_of): BM 16 x BN 64 for M <= 16 (rows
// past M are zeros in the m16 mma; the weight's bytes bound that width, so
// wasting them costs nothing), 64 x 64 up to M 64, 128 x 128 above (each
// warp 64 x 32: the fewest ldmatrix loads an mma).
//
// The split contraction (both bodies): where the grid of output tiles has
// fewer blocks than the card has SMs, D is cut into S slices of whole BK
// tiles (blockIdx.z), so that the grid holds about one to two blocks an SM
// (at F 768, D 3072, M 8: 12 column tiles x 24 slices). Each block writes
// its f32 partial tile into slice z of a workspace [S, M, F]; then, after
// __threadfence(), it takes a ticket on its tile's counter (atomicAdd), and
// the last block of the tile to finish sums the S partials IN SLICE ORDER
// into o and resets the counter to 0 for the next launch. The result is
// deterministic (the same bits every call; no float atomics), and one
// launch does the whole matmul. The counters belong to one device and one
// stream at a time: launches on a device are serialized by its stream.
//
// Tails: rows of x past M, columns past F and contraction rows past D stage
// as zeros and are never written. Where F (int8) or D (bf16 x) is not a
// multiple of 16 bytes, or a pointer is not 16-byte aligned, the tiles
// stage with element loads in the same kernel.
//
// C interface for ctypes: mpit_qmm_plan fills the plan (body, tile, S,
// blocks) for a shape on the current device; mpit_quantized_matmul launches
// it and returns the cudaError_t of the launch (cudaGetLastError right
// after it), or -1 for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_mma.cuh"

namespace {

namespace am = attn_mma;
using bf16 = __nv_bfloat16;

enum Body { BODY_FMA = 0, BODY_MMA = 1 };

// ---- the split contraction's end --------------------------------------------

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Called by every thread of a block that has written its partial tile
// (rows m0 .., columns n0 .., at most BM x BN) into its slice of ws [S, M,
// F]: the last block of the tile to finish sums the S slices in order into
// o and resets the tile's counter.
template <int THREADS, int BM, int BN>
__device__ void finish_split(const float* __restrict__ ws, float* __restrict__ o,
                             unsigned int* counter, int splits, int m, int f, int m0,
                             int n0) {
  constexpr int U = 2;   // groups of four columns a thread sums at once
  constexpr int ZB = 8;  // slices whose loads are in flight together
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == unsigned(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(BM, m - m0);
  const size_t slice = static_cast<size_t>(m) * f;
  if (f % 4 == 0) {
    // U groups of four columns a thread; their loads of ZB slices are
    // issued together, then added in slice order.
    const int groups = rows * (BN / 4);
    for (int e0 = threadIdx.x; e0 < groups; e0 += THREADS * U) {
      size_t at[U];
      bool ok[U];
      float4 acc[U] = {};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        const int gn = n0 + 4 * (e % (BN / 4));
        ok[u] = e < groups && gn < f;
        at[u] = ok[u] ? static_cast<size_t>(m0 + e / (BN / 4)) * f + gn : 0;
      }
      for (int z0 = 0; z0 < splits; z0 += ZB) {
        float4 p[ZB][U];
#pragma unroll
        for (int j = 0; j < ZB; ++j)
#pragma unroll
          for (int u = 0; u < U; ++u)
            p[j][u] = ok[u] && z0 + j < splits
                          ? __ldcg(reinterpret_cast<const float4*>(ws + (z0 + j) * slice + at[u]))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < ZB; ++j) {
          if (z0 + j >= splits) break;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (z0 + j == 0) acc[u] = p[j][u];
            else add4(acc[u], p[j][u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) *reinterpret_cast<float4*>(o + at[u]) = acc[u];
    }
  } else {
    for (int e = threadIdx.x; e < rows * BN; e += THREADS) {
      const int gn = n0 + e % BN;
      if (gn >= f) continue;
      const size_t at = static_cast<size_t>(m0 + e / BN) * f + gn;
      float acc = __ldcg(ws + at);
      for (int z = 1; z < splits; ++z) acc += __ldcg(ws + z * slice + at);
      o[at] = acc;
    }
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// ---- fma body: f32 x on the CUDA cores --------------------------------------

namespace fmab {

constexpr int VEC = 16;               // int8 weights per load = columns a thread
constexpr int TX = 8;                 // threads along F
constexpr int BN = TX * VEC;          // 128 columns a block
constexpr int KS = 32;                // contraction slices a block
constexpr int NTHREADS = TX * KS;     // 256
constexpr int BM = 8;                 // rows of x a block
constexpr int R = 4;                  // weight rows a slice loads per chunk
constexpr int BK = KS * R;            // 128 contraction rows a chunk
constexpr int WARPS = NTHREADS / 32;  // 8; a warp holds 32 / TX = 4 slices

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

// Grid (ceil(F / BN), ceil(M / BM), S). Thread (tx, ks) owns columns n0 +
// 16 tx .. + 15 and the contraction rows k = ks, ks + KS, ... of each chunk
// of BK rows of this block's slice of D, kps chunks from z * kps * BK.
__global__ void __launch_bounds__(NTHREADS, 1)
    qmm_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ o,
                   float* __restrict__ ws, unsigned int* __restrict__ counters,
                   int m, int d, int f, int kps, bool vec_ok) {
  __shared__ float x_s[BM][BK];
  __shared__ __align__(16) float part[WARPS][BM * BN];

  const int tx = threadIdx.x % TX;
  const int ks = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n = n0 + tx * VEC;
  const int splits = gridDim.z;
  const int kb = blockIdx.z * kps * BK;
  const int ke = min(d, kb + kps * BK);

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
    const int k = kb + ks + KS * r;
    wv[r] = load_row16(q, k, n, d, f, vec_ok);
    sv[r] = k < d ? s[k] : 0.f;
  }

  for (int k0 = kb; k0 < ke; k0 += BK) {
    // Stage x[m0 : m0 + BM, k0 : k0 + BK] as f32, zeros past M and D.
    for (int i = threadIdx.x; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      x_s[r][c] = (gm < m && gk < d) ? x[(size_t)gm * d + gk] : 0.f;
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
    if (k0 + BK < ke) {
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
        w[j] = __fmul_rn(byte_f32(words[j / 4], j % 4), cur_s[r]);
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
  float* dst = splits == 1 ? o : ws + (size_t)blockIdx.z * m * f;
  for (int e = threadIdx.x * 4; e < BM * BN; e += NTHREADS * 4) {
    float4 sum = *reinterpret_cast<const float4*>(&part[0][e]);
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      add4(sum, *reinterpret_cast<const float4*>(&part[w][e]));
    }
    const int gm = m0 + e / BN;
    const int gn = n0 + e % BN;
    if (gm < m) {
      float* out = dst + (size_t)gm * f;
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gn + c < f) out[gn + c] = vals[c];
      }
    }
  }
  if (splits > 1) {
    finish_split<NTHREADS, BM, BN>(ws, o, counters + blockIdx.y * gridDim.x + blockIdx.x,
                                   splits, m, f, m0, n0);
  }
}

}  // namespace fmab

// ---- mma body: bf16 x on the tensor cores, three pieces of each weight ------

namespace mmab {

constexpr int BK = 32;       // contraction rows a stage
constexpr int XLD = BK + 8;  // row stride of the staged x tile (elements)

// A block tile: BM x BN outputs, WM x WN warps, each owning (BM / WM) x
// (BN / WN): MI m16 blocks by NI n8 blocks; STAGES staged contraction tiles
// (at least 3: the tile being multiplied, the one being split, the one in
// flight) and two sets of three piece tiles.
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int MI = BM / WM / 16;
  static constexpr int NI = BN / WN / 8;
  static constexpr int WLD = BN + 8;  // row stride of a piece tile (elements)
  // One stage: the int8 tile [BK][BN], its BK f32 scales, the x tile
  // [BM][XLD] bf16 (every part a multiple of 16 bytes).
  static constexpr int Q_OFF = 0;
  static constexpr int S_OFF = BK * BN;
  static constexpr int X_OFF = S_OFF + BK * 4;
  static constexpr int STAGE_BYTES = X_OFF + BM * XLD * 2;
  static constexpr int PIECE_ELEMS = BK * WLD;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * 3 * PIECE_ELEMS * 2;
  static_assert(MI >= 1 && NI % 2 == 0, "a warp takes whole m16 x n16 blocks");
  static_assert(STAGES >= 3, "multiply, split and load three tiles at once");
  static_assert(BN % 16 == 0 && BM * WM * WN > 0, "tile shape");
};

// The three tiles plan_of picks from.
using T16 = Tile<16, 64, 1, 4, 4, 4>;     // M <= 16: the decode tick
using T64 = Tile<64, 64, 2, 2, 4, 3>;     // 16 < M <= 64
using T128 = Tile<128, 128, 2, 4, 4, 2>;  // M > 64: the prefill widths

// Stage contraction tile k0 of the block (rows m0 .. of x, columns n0 .. of
// q) into st, zeros past M, D and F: 16-byte cp.async copies where the rows
// allow them (q_vec: F % 16 == 0 and q aligned; x_vec: D % 8 == 0 and x
// aligned), else element loads.
template <class T>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const bf16* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ s, int m,
                                           int d, int f, int m0, int n0, int k0,
                                           bool q_vec, bool x_vec) {
  int8_t* qs = reinterpret_cast<int8_t*>(st + T::Q_OFF);
  float* ss = reinterpret_cast<float*>(st + T::S_OFF);
  bf16* xs = reinterpret_cast<bf16*>(st + T::X_OFF);
  constexpr int QCH = T::BN / 16;  // 16-byte chunks of a weight row
  for (int i = threadIdx.x; i < BK * QCH; i += T::THREADS) {
    const int r = i / QCH, c = (i % QCH) * 16;
    const int k = k0 + r, n = n0 + c;
    int8_t* dst = qs + r * T::BN + c;
    if (q_vec) {
      const bool ok = k < d && n < f;  // F % 16 == 0: a chunk is all in or out
      am::cp_async16(dst, ok ? q + (size_t)k * f + n : q, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (k < d && n + j < f) ? q[(size_t)k * f + n + j] : int8_t(0);
    }
  }
  for (int i = threadIdx.x; i < BK; i += T::THREADS) {
    const int k = k0 + i;
    am::cp_async4(ss + i, k < d ? s + k : s, k < d);
  }
  constexpr int XCH = BK / 8;  // 16-byte chunks of an x row
  for (int i = threadIdx.x; i < T::BM * XCH; i += T::THREADS) {
    const int r = i / XCH, c = (i % XCH) * 8;
    const int gm = m0 + r, gk = k0 + c;
    bf16* dst = xs + r * XLD + c;
    if (x_vec) {
      const bool ok = gm < m && gk < d;  // D % 8 == 0: all in or out
      am::cp_async16(dst, ok ? x + (size_t)gm * d + gk : x, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gm < m && gk + j < d) ? x[(size_t)gm * d + gk + j]
                                        : __float2bfloat16(0.f);
    }
  }
}

// Byte j of a 32-bit word as a signed int8, in f32, exactly: the float
// 2^23 + (byte ^ 0x80) built from its bits, less 2^23 + 128 (integer and
// add pipes rather than the slower conversion unit).
__device__ __forceinline__ float s8_f32(unsigned int word, int j) {
  return __uint_as_float(0x4B000000u | (((word >> (8 * j)) & 0xffu) ^ 0x80u)) - 8388736.f;
}

// Dequantize a staged int8 tile and split it into the three bf16 piece
// tiles: eight weights of a row a step, each the f32 product float(q) * s.
template <class T>
__device__ __forceinline__ void dequant_split(const unsigned char* st,
                                              bf16* pieces) {
  const int8_t* qs = reinterpret_cast<const int8_t*>(st + T::Q_OFF);
  const float* ss = reinterpret_cast<const float*>(st + T::S_OFF);
  constexpr int GPR = T::BN / 8;  // groups of 8 a row
  for (int i = threadIdx.x; i < BK * GPR; i += T::THREADS) {
    const int r = i / GPR, c = (i % GPR) * 8;
    const uint2 raw = *reinterpret_cast<const uint2*>(qs + r * T::BN + c);
    const float sc = ss[r];
    const unsigned int words[2] = {raw.x, raw.y};
    float w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = __fmul_rn(s8_f32(words[j / 4], j % 4), sc);
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) am::split3(w[2 * p], w[2 * p + 1], hi[p], mid[p], lo[p]);
    const int at = r * T::WLD + c;
    *reinterpret_cast<uint4*>(pieces + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(pieces + T::PIECE_ELEMS + at) =
        make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(pieces + 2 * T::PIECE_ELEMS + at) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Grid (ceil(F / BN), ceil(M / BM), S); block z walks contraction tiles
// [z kps, min((z + 1) kps, ceil(D / BK))).
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    qmm_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ o,
                   float* __restrict__ ws, unsigned int* __restrict__ counters,
                   int m, int d, int f, int kps, bool q_vec, bool x_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const pieces_base = reinterpret_cast<bf16*>(smem + T::STAGES * T::STAGE_BYTES);
  auto stage = [&](int i) { return smem + (i % T::STAGES) * T::STAGE_BYTES; };
  auto pieces = [&](int i) { return pieces_base + (i % 2) * 3 * T::PIECE_ELEMS; };

  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * T::BN;
  const int splits = gridDim.z;
  const int kt_total = (d + BK - 1) / BK;
  const int kt0 = blockIdx.z * kps;
  const int n_kt = min(kt0 + kps, kt_total) - kt0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < T::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The first STAGES - 1 tiles in flight (one commit group each, empty
  // past the slice, so that the group count stays uniform), and tile 0
  // split.
#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) {
    if (i < n_kt)
      load_stage<T>(stage(i), x, q, s, m, d, f, m0, n0, (kt0 + i) * BK, q_vec, x_vec);
    am::cp_async_commit();
  }
  am::cp_async_wait<T::STAGES - 2>();
  __syncthreads();
  dequant_split<T>(stage(0), pieces(0));
  for (int t = 0; t < n_kt; ++t) {
    am::cp_async_wait<T::STAGES - 3>();  // tile t + 1 has landed (this thread's part)
    // Every thread's part of tile t + 1 has landed and tile t is split;
    // tile t - 1's x tile and piece tiles are done with.
    __syncthreads();
    const int nt = t + T::STAGES - 1;
    if (nt < n_kt)
      load_stage<T>(stage(nt), x, q, s, m, d, f, m0, n0, (kt0 + nt) * BK, q_vec, x_vec);
    am::cp_async_commit();
    if (t + 1 < n_kt) dequant_split<T>(stage(t + 1), pieces(t + 1));
    const bf16* xs = reinterpret_cast<const bf16*>(stage(t) + T::X_OFF);
    const bf16* pc_t = pieces(t);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[T::MI][4];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        am::ldsm_x4(a[mi], xs + (wm * T::MI * 16 + mi * 16 + (lane & 15)) * XLD +
                               ks * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
        const bf16* w_s = pc_t + pc * T::PIECE_ELEMS;
#pragma unroll
        for (int np = 0; np < T::NI / 2; ++np) {
          // Matrices: k 0-7 / 8-15 of columns 0-7, then of columns 8-15.
          uint32_t b[4];
          am::ldsm_x4_trans(b, w_s + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * T::WLD +
                                   wn * T::NI * 8 + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < T::MI; ++mi) {
            am::mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
            am::mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  }

  // C fragments out: element pair h of acc[mi][ni] is row g + 8 h, columns
  // 2 t, 2 t + 1 of its 16 x 8 block.
  float* dst = splits == 1 ? o : ws + (size_t)blockIdx.z * m * f;
  const bool pair_ok = f % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * T::MI * 16 + mi * 16 + (lane >> 2) + 8 * h;
      if (row >= m) continue;
      float* out = dst + (size_t)row * f;
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = n0 + wn * T::NI * 8 + ni * 8 + 2 * (lane & 3);
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pair_ok && col + 1 < f) {
          *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
        } else {
          if (col < f) out[col] = v0;
          if (col + 1 < f) out[col + 1] = v1;
        }
      }
    }
  }
  if (splits > 1) {
    finish_split<T::THREADS, T::BM, T::BN>(
        ws, o, counters + blockIdx.y * gridDim.x + blockIdx.x, splits, m, f, m0, n0);
  }
}

}  // namespace mmab

// ---- the plan --------------------------------------------------------------

enum TileId { TILE_FMA, TILE_16, TILE_64, TILE_128 };

struct Plan {
  Body body;
  TileId tile;
  int bm, bn, bk;
  int tiles_m, tiles_n;
  int kps;     // contraction tiles a slice
  int splits;  // S
  long long blocks;
};

constexpr int MAX_DEVICES = 64;

// The SM count of the current device (cached per device).
int sm_count(int* out) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && cached[dev]) {
    *out = cached[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) cached[dev] = *out;
  return 0;
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// The body, tile and split for x [m, d] (x_dtype 0 f32, 1 bf16) against an
// int8 [d, f] weight on a card of `sms` SMs. bf16 x takes the tensor cores
// (mma), f32 x the FMA body. The tile: 16 x 64 for m <= 16 (the decode
// width), 64 x 64 up to m 64, 128 x 128 above. The
// split: where the tiles are fewer than `target` blocks (one an SM for the
// prefill tiles, two for the decode tile, whose time is the weight's bytes
// in flight and whose blocks are small), D is cut into the fewest slices of
// kps whole BK tiles that bring tiles x S to `target`. The FMA body holds
// one block an SM, so its split stops at one wave: the most slices with
// tiles x S <= sms.
Plan plan_of(int m, int d, int f, int x_dtype, int sms) {
  Plan p{};
  int target;
  if (x_dtype == 0) {
    p.body = BODY_FMA;
    p.tile = TILE_FMA;
    p.bm = fmab::BM;
    p.bn = fmab::BN;
    p.bk = fmab::BK;
    target = sms;
  } else {
    p.body = BODY_MMA;
    p.bk = mmab::BK;
    if (m <= 16) {
      p.tile = TILE_16;
      p.bm = mmab::T16::BM;
      p.bn = mmab::T16::BN;
      target = 2 * sms;
    } else if (m <= 64) {
      p.tile = TILE_64;
      p.bm = mmab::T64::BM;
      p.bn = mmab::T64::BN;
      target = sms;
    } else {
      p.tile = TILE_128;
      p.bm = mmab::T128::BM;
      p.bn = mmab::T128::BN;
      target = sms;
    }
  }
  p.tiles_m = ceil_div(m, p.bm);
  p.tiles_n = ceil_div(f, p.bn);
  const long long tiles = static_cast<long long>(p.tiles_m) * p.tiles_n;
  const int kt = ceil_div(d, p.bk);
  if (p.body == BODY_FMA) {
    const long long most = tiles < target ? target / tiles : 1;
    p.kps = ceil_div(kt, most);
  } else {
    const int want = tiles < target ? ceil_div(target, tiles) : 1;
    p.kps = kt / want > 0 ? kt / want : 1;
  }
  p.splits = ceil_div(kt, p.kps);
  p.blocks = tiles * p.splits;
  return p;
}

template <class K>
int set_smem(K kernel, int tile, int bytes) {
  // Once per device and tile: above 48 KB a block's shared memory must be
  // asked for.
  static bool done[MAX_DEVICES][4] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES && done[dev][tile]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < MAX_DEVICES) done[dev][tile] = true;
  return 0;
}

template <class T>
int launch_mma(const Plan& p, const bf16* x, const int8_t* q, const float* s,
               float* o, float* ws, unsigned int* counters, int m, int d,
               int f, bool q_vec, bool x_vec, cudaStream_t stream) {
  auto kernel = mmab::qmm_mma_kernel<T>;
  const int err = set_smem(kernel, p.tile, T::SMEM);
  if (err) return err;
  const dim3 grid(p.tiles_n, p.tiles_m, p.splits);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(x, q, s, o, ws, counters, m, d,
                                                f, p.kps, q_vec, x_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan for x [m, d] (x_dtype 0 f32, 1 bf16) against an int8 [d, f]
// weight on the current device: out[0] the body (0 fma, 1 mma), out[1] and
// out[2] the tile's rows and columns, out[3] the split S, out[4] the grid's
// blocks. Returns 0, -1 for arguments the kernel does not take, or a CUDA
// error code.
int mpit_qmm_plan(int m, int d, int f, int x_dtype, int* out) {
  if (m < 1 || d < 1 || f < 1 || x_dtype < 0 || x_dtype > 1) return -1;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const Plan p = plan_of(m, d, f, x_dtype, sms);
  out[0] = p.body;
  out[1] = p.bm;
  out[2] = p.bn;
  out[3] = p.splits;
  out[4] = static_cast<int>(p.blocks);
  return 0;
}

// x [m, d] (x_dtype 0 = float32, 1 = bfloat16), q [d, f] int8, s [d] f32,
// o [m, f] f32; all contiguous. Where the plan splits the contraction (S >
// 1), ws is an f32 workspace [S, m, f] and counters holds n_counters zeroed
// 32-bit words, at least the plan's output tiles; otherwise both may be
// null.
int mpit_quantized_matmul(const void* x, const void* q, const void* s, void* o,
                          void* ws, void* counters, int n_counters, int m,
                          int d, int f, int x_dtype, void* stream) {
  if (m < 1 || d < 1 || f < 1 || x_dtype < 0 || x_dtype > 1) return -1;
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const Plan p = plan_of(m, d, f, x_dtype, sms);
  if (p.tiles_m > 65535 || p.splits > 65535) return -1;
  if (p.splits > 1 &&
      (ws == nullptr || counters == nullptr ||
       static_cast<long long>(p.tiles_m) * p.tiles_n > n_counters))
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(s);
  auto* op = static_cast<float*>(o);
  auto* wp = static_cast<float*>(ws);
  auto* cp = static_cast<unsigned int*>(counters);
  const bool q_vec = f % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (p.body == BODY_FMA) {
    const dim3 grid(p.tiles_n, p.tiles_m, p.splits);
    fmab::qmm_fma_kernel<<<grid, fmab::NTHREADS, 0, st>>>(
        static_cast<const float*>(x), qp, sp, op, wp, cp, m, d, f, p.kps, q_vec);
    return static_cast<int>(cudaGetLastError());
  }
  const auto* xp = static_cast<const bf16*>(x);
  const bool x_vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (p.tile) {
    case TILE_16:
      return launch_mma<mmab::T16>(p, xp, qp, sp, op, wp, cp, m, d, f, q_vec, x_vec, st);
    case TILE_64:
      return launch_mma<mmab::T64>(p, xp, qp, sp, op, wp, cp, m, d, f, q_vec, x_vec, st);
    default:
      return launch_mma<mmab::T128>(p, xp, qp, sp, op, wp, cp, m, d, f, q_vec, x_vec, st);
  }
}

const char* mpit_qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
