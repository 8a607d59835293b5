// Ring reduce-scatter and all-gather for Hopper (sm_90a), sum and int8 wire,
// over p ranks on this one card whose buffers are named by a per-rank
// pointer table.
//
// Replaces the TPU kernels of mpit_tpu/ops/ring_collectives.py, all four
// reached through _call_ring (:546, pl.pallas_call at :550):
//   - rs_fold_kernel<T, MAXP>        <- _rs_kernel    (:350)  sum, in x's dtype
//   - rs_q8_fold_kernel<T, RESIDENT> <- _rs_q8_kernel (:387)  int8 wire, f32
//                                                             result
//   - ag_copy_kernel<T>              <- _ag_kernel    (:429)  sum
//   - ag_q8_copy_kernel<T, RESIDENT> <- _ag_q8_kernel (:457)  int8 wire
// Every rank's buffer lies in this card's HBM, so nothing has to travel:
// each runs as one pass over HBM (the q8 fold one pass a hop where its
// partials outgrow shared memory, the q8 copy two where its shard does).
// The ring's hop schedule, for the launch across cards, is rebuilt with
// the hardware that needs it (ROADMAP.md, "B1 across cards").
//
// What they compute, per rank i of p, on [rows, 128] chunks:
//   reduce-scatter: rank i's input holds p chunks; at step s (0..p-2) it
//     sends chunk (i-1-s) mod p (s = 0) or its running partial (s >= 1) to
//     rank i+1 and folds the partial arriving from rank i-1 into its own
//     chunk (i-2-s) mod p. After p-1 steps its output holds chunk i summed
//     over every rank. The q8 form quantizes each outgoing partial to int8
//     with ONE scale over the whole chunk (amax / 127, 1 for an all-zero
//     chunk, round half to even, clip to +-127) and the receiver computes
//     f32(q) * scale + f32(x) with two roundings (no FMA), as the plain
//     version and the JAX package do.
//   all-gather: rank i contributes chunk i; chunks travel the ring in the
//     same order; every rank ends with all p. The q8 form quantizes each
//     rank's own chunk once; the int8 payload and its scale travel
//     verbatim, and every rank, the owner included, writes the dequantized
//     value, so every replica holds the same bits.
//
// What bounds them on this card: the function's least traffic. A
// reduce-scatter reads p chunks of every rank and writes one chunk per rank
// (p*p*c in, p*c out); an all-gather reads p*c and writes p*p*c. At
// GPT-2 small's bucket (p 4, 8192 rows of 128 f32 per chunk, 4 MiB) that
// is 80 MiB, about 0.025 ms at 3.35 TB/s.
//
// The sum reduce-scatter: rs_fold_kernel, one pass. For rank r and each
// element of chunk r it loads the p ranks' copies and adds them in the
// ring's own order, with the ring's own roundings:
//   acc = x[r+1][r];  for j = 2..p: acc = round_T(acc + x[r+j][r])
// (rank indices mod p; chunk r leaves rank r + 1 at step 0 and each later
// rank adds its own copy, the last being rank r's). Each add is __fadd_rn
// in f32 and is rounded to T, as a hop's partial is stored in T, so the
// result is bit-equal to the ring and to the plain version
// (reduce_scatter_plain) in f32 and bf16. It moves the bound's bytes:
// p*p*c read once, p*c written once. Its design is a bandwidth kernel's: a
// plain launch (no block waits on another) of blocks that fill every SM,
// grid (ceil(groups / 256), p) with blockIdx.y the rank, each thread taking
// one 16-byte group (4 f32 or 8 bf16), all p loads of the group started
// before the first add so p * 16 bytes a thread are in flight, streaming
// loads and stores (__ldcs / __stcs: every byte is touched once), the
// group's registers sized to p (MAXP 4, 8 or 16).
//
// The sum all-gather: ag_copy_kernel, one pass, of the fold's design. An
// all-gather is a copy: chunk c of every rank's output is rank c's shard.
// So each thread loads one 16-byte group of rank c's shard once (__ldcs)
// and stores it into chunk c of all p ranks' outputs, the p stores issued
// back to back (__stcs): p*c read, p*p*c written, the bound's bytes, with
// blockIdx.y the source rank c.
//
// The q8 reduce-scatter: the q8 fold, rs_q8_fold_kernel. For rank r it
// computes the hop chain of chunk r directly, with the ring's roundings:
//   P_0 = f32(x[r+1][r]);  s_j = amax(P_j) / 127 over the WHOLE chunk (1 if
//   all zero);  P_j = f32(clip(rint(P_{j-1} / s_{j-1}), +-127)) * s_{j-1}
//   + f32(x[r+1+j][r]) for j = 1 .. p-1, each step rounded once (no FMA);
//   out = P_{p-1}.
// The int8 value lives only in a register (only dequant(quant(P)) reaches
// the result). A hop computes its block's amax of the new partial in the
// same pass that makes it, and the rank's blocks meet at the amax barrier
// before the next hop. Two forms, chosen by the plan (q8_plan):
//   - resident, whenever a block's rows of the f32 partial fit in the
//     shared memory a block may take (GPT-2 small's bucket at p 4: 249
//     rows, 127 KB a block): P stays in shared memory across the hops, so
//     HBM moves the bound's bytes;
//   - streaming, when they do not (p 8 at 8192 rows): P lives in out; hop 0
//     reads x[r+1][r] for its amax, hop 1 reads it again with x[r+2][r] and
//     writes out, each later hop reads out and x and rewrites out, one pass
//     a hop.
// Each thread takes the same 16-byte groups of x at every hop, and the next
// trip's groups are in flight while a trip is computed, across the amax
// barrier too. What holds it above the bound (PERF.md): at each of the
// p - 1 barriers every block of the rank waits for the slowest, and at
// bf16 the hops' compute and the barriers outweigh the bytes.
//
// The q8 all-gather: the q8 copy, ag_q8_copy_kernel. For source rank c and
// every rank r:
//   out[r][c] = T(f32(clip(rint(x_c / s_c), +-127)) * s_c),
//   s_c = amax|x_c| / 127 over the WHOLE chunk (1 if all zero),
// the product rounded once to f32 and once more to T. The int8 value lives
// only in a register, so every replica holds the same bits with nothing
// shipped. Blocks (b, c) read their rows of shard c once, take their amax,
// meet the chunk's other blocks at ONE amax barrier, then write each
// dequantized 16-byte group into chunk c of all p outputs, the p stores
// back to back (__stcs), as the copy does. Two forms, by the same plan:
//   - resident, whenever a block's rows of x, in x's own dtype, fit in the
//     shared memory a block may take (f32 p 4 at 8192 rows: 249 rows, 127
//     KB; bf16 up to p 8): the amax pass stages them there, so HBM moves
//     the bound's bytes, p*c read once and p*p*c written;
//   - streaming, when they do not (f32 p 8 at 8192 rows: 512 rows, 256
//     KiB): the store pass reads the rows again (the amax pass loads them
//     through L2 without evicting them first, so they are mostly still
//     there).
//
// The divide of the q8 forms by a chunk's scale is a product with its
// correctly rounded reciprocal corrected once (q8_quot), bit-equal to
// __fdiv_rn, and the rounded quotient is made +0 where it is -0, as the
// int8 value it stands for has no sign. Both are bit-equal to their plain
// versions (reduce_scatter_plain / all_gather_plain with quantized) in f32
// and bf16 input. A NaN is dropped by the amax (fmaxf) and quantizes to
// -127.
//
// The amax barrier (rank_amax), the one dependency across blocks: ONE
// cooperative launch carries all p chunks, grid (B, p) with blockIdx.y the
// chunk, and block b owns rows [b*rows/B, (b+1)*rows/B) of it. Each block
// publishes its partial amax, and every block of the chunk waits for all B
// partials and takes their max (exact, so order does not matter).
// p*B <= the SM count and the launch is cooperative, so every block is
// resident and no spin-wait can wait on a block that is not running.
// Flags are never cleared: a token is epoch * 256 + barrier + 1, the epoch
// a per-device call counter from the wrapper, so every token is larger
// than any left over from an earlier call or bucket (launches on one
// stream finish in order). Memory order: one thread stores the partial,
// then the flag with st.release.gpu; a reader's thread spins with
// ld.acquire.gpu and reads the partials through L2 (ld.global.cg): L1 is
// not coherent across SMs. Every spin has a budget of clock64 cycles; when
// it runs out the kernel writes an error word into mapped host memory
// (readable after the context is lost) and traps, so a hung barrier ends
// the launch instead of hanging it.
//
// C interface for ctypes: mpit_ring_launch returns the cudaError_t of the
// launch (cudaGetLastError right after it) or -1 for arguments this file
// does not take; mpit_ring_error reads the error word, 0 if none;
// mpit_q8_plan names a q8 form. Kinds 0, 1, 2 and 3 are the fold, the q8
// fold, the copy and the q8 copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 512;            // threads per block of the q8 forms
constexpr int MAX_RANKS = 16;      // pointer-table entries
constexpr int MAXB = 256;          // blocks per chunk, at most
constexpr int LANE = 128;
// Workspace of one rank, in 64-bit words (zeroed once by the wrapper):
constexpr int WS_ARRIVE = 0;       // [MAXB] amax-barrier flags
constexpr int WS_PART = MAXB;      // [2][MAXB] f32 partial amax
constexpr long long SPIN_BUDGET = 1LL << 32;  // clock64 cycles, ~2 s

typedef unsigned long long u64;

// The q8 forms' arguments.
struct RingArgs {
  const void* in[MAX_RANKS];
  void* out[MAX_RANKS];
  u64* ws[MAX_RANKS];
  long long in_cs, out_cs;  // elements between chunks of the p-chunk side
  int p, rows, nblk;
  u64 epoch;
  volatile unsigned int* err;  // mapped host memory
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 token(const RingArgs& a, int i) {
  return a.epoch * 256ull + static_cast<u64>(i) + 1ull;
}

// Error word of a timed-out amax barrier: 1 | the workspace's rank << 8 |
// block << 16 | barrier << 24, then a trap.
__device__ __noinline__ void fail(const RingArgs& a, int barrier) {
  *a.err = 1u | (blockIdx.y << 8) | (blockIdx.x << 16) |
           (static_cast<unsigned int>(barrier) << 24);
  __threadfence_system();
  __trap();
}

// One thread waits until *f >= want, within the budget.
__device__ __forceinline__ void spin(const RingArgs& a, const u64* f, u64 want, int barrier) {
  const long long t0 = clock64();
  while (ld_acquire(f) < want) {
    if (clock64() - t0 > SPIN_BUDGET) fail(a, barrier);
    __nanosleep(32);
  }
}

__device__ __forceinline__ float q8_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NT / 32 ? red[lane] : 0.f;
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The chunk-wide amax of the chunk of blockIdx.y: this block's partial,
// published (the release store orders it before the flag), then the max
// over the partials of every block of the chunk (barrier k), on the
// workspace of rank blockIdx.y.
__device__ float rank_amax(const RingArgs& a, float mine, int k, float* red) {
  const int r = blockIdx.y, b = blockIdx.x;
  u64* ws = a.ws[r];
  float* part = reinterpret_cast<float*>(ws + WS_PART);
  const float bmax = block_max(mine, red);
  const u64 tok = token(a, k);
  if (threadIdx.x == 0) {
    part[(k & 1) * MAXB + b] = bmax;
    st_release(ws + WS_ARRIVE + b, tok);
  }
  float v = 0.f;
  if (threadIdx.x < a.nblk) {
    spin(a, ws + WS_ARRIVE + threadIdx.x, tok, k);
    v = __ldcg(part + (k & 1) * MAXB + threadIdx.x);
  }
  return block_max(v, red);
}

// Block blockIdx.x's rows [lo, hi) of a chunk.
struct Rows {
  long long lo, hi;
};

__device__ __forceinline__ Rows my_rows(const RingArgs& a) {
  return Rows{static_cast<long long>(blockIdx.x) * a.rows / a.nblk,
              static_cast<long long>(blockIdx.x + 1) * a.rows / a.nblk};
}

// ---- the one-card sum reduce-scatter: one pass ------------------------------

constexpr int PASS_NT = 256;  // threads per block of the sum kernels

// The sum kernels' arguments (the fold's and the copy's).
struct PassArgs {
  const void* in[MAX_RANKS];
  void* out[MAX_RANKS];
  long long cs;   // elements between chunks of the p-chunk side (the fold's
                  // input, the copy's output)
  long long n16;  // 16-byte groups of a chunk
  int p;
};

// The 16 bytes of a group as floats, and back, rounding to T.
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x); v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z); v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&v)[8]) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  unsigned int w[4];
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned int*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// MAXP: the ranks this instantiation takes at most (4, 8 or MAX_RANKS), so
// that the group's registers are sized to p, not to the table.
template <typename T, int MAXP>
__global__ void __launch_bounds__(PASS_NT) rs_fold_kernel(PassArgs a) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte group
  const int p = a.p, r = blockIdx.y;
  const long long g = static_cast<long long>(blockIdx.x) * PASS_NT + threadIdx.x;
  if (g >= a.n16) return;
  const long long chunk = static_cast<long long>(r) * a.cs;
  // Every rank's copy of this group of chunk r, in ring order: raw[j] is
  // rank r + 1 + j's. All p loads start before the first add.
  uint4 raw[MAXP];
  #pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    if (j < p) {
      const int src = (r + 1 + j) % p;
      raw[j] = __ldcs(reinterpret_cast<const uint4*>(
                          static_cast<const T*>(a.in[src]) + chunk) + g);
    }
  }
  float acc[VEC];
  unpack16(raw[0], acc);
  #pragma unroll
  for (int j = 1; j < MAXP; ++j) {
    if (j < p) {
      float x[VEC];
      unpack16(raw[j], x);
      #pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
      if constexpr (VEC == 8) unpack16(pack16(acc), acc);  // round to bf16
    }
  }
  __stcs(static_cast<uint4*>(a.out[r]) + g, pack16(acc));
}

// ---- the one-card sum all-gather: one pass ----------------------------------

template <typename T>
__global__ void __launch_bounds__(PASS_NT) ag_copy_kernel(PassArgs a) {
  const int c = blockIdx.y;  // the source rank, and the chunk it fills
  const long long g = static_cast<long long>(blockIdx.x) * PASS_NT + threadIdx.x;
  if (g >= a.n16) return;
  const uint4 v = __ldcs(reinterpret_cast<const uint4*>(a.in[c]) + g);
  const long long chunk = static_cast<long long>(c) * a.cs;
  #pragma unroll 4
  for (int r = 0; r < a.p; ++r)
    __stcs(reinterpret_cast<uint4*>(static_cast<T*>(a.out[r]) + chunk) + g, v);
}

// ---- the q8 forms' arithmetic ----------------------------------------------

// The quotient p / s rounded once to f32, as __fdiv_rn gives it. With
// `fast` (s and its reciprocal r = __frcp_rn(s) both far from overflow and
// underflow, which the caller checks once a hop: s is the hop's one scale)
// it is p * r corrected once by its exact fma residual (Markstein's
// correction: from the correctly rounded reciprocal, one residual step
// rounds the quotient correctly), three instructions in place of
// __fdiv_rn's. Where the product underflows, |p / s| < 2^-26 and both
// round to a zero of p's sign after rint. mpit_q8_quot_mismatches holds
// the two forms against each other on the card.
__device__ __forceinline__ float q8_quot(float p, float s, float r, bool fast) {
  if (!fast) return __fdiv_rn(p, s);
  const float q0 = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-q0, s, p), r, q0);
}

// Whether q8_quot may take its fast form for the scale s.
__device__ __forceinline__ bool q8_fast(float s) { return s >= 0x1p-100f && s <= 0x1p100f; }

// dequant(quant(v)) for one element: round(v / s) half to even, clipped to
// +-127, -0 made +0 (the int8 value has no sign), times s; every step
// rounded once, as the plain version.
__device__ __forceinline__ float q8_dq(float v, float s, float r, bool fast) {
  const float q = fminf(fmaxf(rintf(q8_quot(v, s, r, fast)), -127.f), 127.f);
  return __fmul_rn(__fadd_rn(q, 0.f), s);
}

// dequant(quant(P)) + x for one element, each step rounded once.
__device__ __forceinline__ float q8_hop(float p, float s, float r, bool fast, float x) {
  return __fadd_rn(q8_dq(p, s, r, fast), x);
}

// For the tests: counts the i < n where q8_quot(p[i], s[i]) differs in any
// bit from __fdiv_rn(p[i], s[i]), for each s[i] in the fast range.
__global__ void q8_quot_check_kernel(const float* p, const float* s, long long n,
                                     unsigned long long* mismatches) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float si = s[i];
  if (!q8_fast(si)) return;
  const float fast = q8_quot(p[i], si, __frcp_rn(si), true);
  if (__float_as_uint(fast) != __float_as_uint(__fdiv_rn(p[i], si))) atomicAdd(mismatches, 1ull);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A trip's UNROLL 16-byte groups of x for this thread, g0 + u * NT (u <
// UNROLL; those at or past ng are not read). LAST: the last read of these
// bytes, so they leave L2 first (__ldcs); else they stay there (__ldcg).
template <int UNROLL, bool LAST = true>
__device__ __forceinline__ void load_trip(const uint4* x, long long g0, long long ng,
                                          uint4 (&raw)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (g0 + u * NT < ng) raw[u] = LAST ? __ldcs(x + g0 + u * NT) : __ldcg(x + g0 + u * NT);
}

// ---- the one-card q8 reduce-scatter: the q8 fold ----------------------------

// Rank r's (blockIdx.y) chunk r, rows of block b (blockIdx.x): P0 = f32 of
// rank r + 1's copy, then P_j = q8_hop(P_{j-1}, s_{j-1}, rank r + 1 + j's
// copy) for j = 1 .. p - 1, s_j the scale of P_j's amax over the WHOLE chunk
// (rank_amax: this block's max, then the max over the rank's blocks).
// RESIDENT: the block's rows of P stay in shared memory from hop to hop and
// reach out once, at the end; else P lives in out (read, rewritten a hop).
// Each thread takes the same 16-byte groups of x at every hop, so its P
// values are its own: no barrier inside the block but the amax's. The loads
// are software-pipelined: a trip's UNROLL groups of x are issued while the
// trip before is computed, and a hop's last trip issues the next hop's
// first, so loads are in flight across the amax barrier (x does not depend
// on the scale; resident at GPT-2 small's bf16 bucket that trip is a
// thread's whole next hop).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(NT) rs_q8_fold_kernel(RingArgs a) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte group
  // Groups of x in flight a thread: resident, 8 (the partial is read from
  // shared memory at its use, so the registers hold x alone); streaming, 4
  // (the partial's groups are loaded from out beside x).
  constexpr int UNROLL = RESIDENT ? 8 : 4;
  constexpr int STEP = UNROLL * NT;
  extern __shared__ float4 resident[];  // [VEC / 4][the block's groups]
  __shared__ float red[NT / 32];
  const int p = a.p, r = blockIdx.y;
  const Rows rw = my_rows(a);
  const long long ng = (rw.hi - rw.lo) * LANE / VEC;  // the block's groups
  const long long x0 = static_cast<long long>(r) * a.in_cs + rw.lo * LANE;
  float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out[r]) + rw.lo * LANE);
  // Hop j's copy: rank r + 1 + j's chunk r, this block's rows.
  auto copy = [&](int j) {
    return reinterpret_cast<const uint4*>(static_cast<const T*>(a.in[(r + 1 + j) % p]) + x0);
  };
  uint4 next[UNROLL];
  load_trip(copy(0), threadIdx.x, ng, next);
  float m = 0.f, s = 1.f, rs = 1.f;
  bool fast = true;
  // One hop's trips, FAST a constant so that no element branches on it.
  auto trips = [&](int j, auto fast_c) {
    constexpr bool FAST = decltype(fast_c)::value;
    const bool last = j == p - 1;
    const uint4* x = copy(j);
    for (long long g0 = threadIdx.x; g0 < ng; g0 += STEP) {
      uint4 raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) raw[u] = next[u];
      if (g0 + STEP < ng) load_trip(x, g0 + STEP, ng, next);
      else if (!last) load_trip(copy(j + 1), threadIdx.x, ng, next);
      float4 prev[RESIDENT ? 1 : UNROLL][VEC / 4];  // streaming: P_{j-1} from out
      if constexpr (!RESIDENT) {
        if (j > 0) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const long long g = g0 + u * NT;
            if (g >= ng) continue;
            if (j == 1) {  // P0 is still rank r + 1's copy
              float v[VEC];
              unpack16(__ldcs(copy(0) + g), v);
#pragma unroll
              for (int k = 0; k < VEC / 4; ++k)
                prev[u][k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
            } else {
#pragma unroll
              for (int k = 0; k < VEC / 4; ++k) prev[u][k] = __ldcg(o + g * (VEC / 4) + k);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = g0 + u * NT;
        if (g >= ng) continue;
        float v[VEC];
        unpack16(raw[u], v);
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k) {
          if (j > 0) {
            const float4 t = RESIDENT ? resident[k * ng + g] : prev[RESIDENT ? 0 : u][k];
            v[4 * k] = q8_hop(t.x, s, rs, FAST, v[4 * k]);
            v[4 * k + 1] = q8_hop(t.y, s, rs, FAST, v[4 * k + 1]);
            v[4 * k + 2] = q8_hop(t.z, s, rs, FAST, v[4 * k + 2]);
            v[4 * k + 3] = q8_hop(t.w, s, rs, FAST, v[4 * k + 3]);
          }
#pragma unroll
          for (int e = 4 * k; e < 4 * k + 4; ++e) m = fmaxf(m, fabsf(v[e]));
        }
        if (j == 0 && !RESIDENT) continue;  // streaming: P0 is not stored
#pragma unroll
        for (int k = 0; k < VEC / 4; ++k) {
          const float4 t = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
          if (last) __stcs(o + g * (VEC / 4) + k, t);
          else if (RESIDENT) resident[k * ng + g] = t;
          else __stcg(o + g * (VEC / 4) + k, t);
        }
      }
    }
  };
  for (int j = 0; j < p; ++j) {
    if (fast) trips(j, Flag<true>{});
    else trips(j, Flag<false>{});
    if (j < p - 1) {
      s = q8_scale(rank_amax(a, m, j, red));  // P_j's scale
      rs = __frcp_rn(s);
      fast = q8_fast(s);
      m = 0.f;
    }
  }
}

// ---- the one-card q8 all-gather: the q8 copy --------------------------------

// Shard c's (blockIdx.y) rows of block b (blockIdx.x), dequant(quant(x))
// with the scale of the WHOLE shard's amax (rank_amax over the chunk's
// blocks), into chunk c of every rank's output, the p stores of a group
// back to back. Pass 1 loads the block's groups and takes their amax;
// RESIDENT stages them in shared memory, in x's dtype, for pass 2, else
// pass 2 loads them again. Each thread takes the same groups in both
// passes, so no barrier inside the block but the amax's.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(NT) ag_q8_copy_kernel(RingArgs a) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte group
  constexpr int UNROLL = 8;
  constexpr int STEP = UNROLL * NT;
  extern __shared__ uint4 staged[];  // RESIDENT: [the block's groups]
  __shared__ float red[NT / 32];
  const int c = blockIdx.y;
  const Rows rw = my_rows(a);
  const long long ng = (rw.hi - rw.lo) * LANE / VEC;  // the block's groups
  const uint4* x = reinterpret_cast<const uint4*>(static_cast<const T*>(a.in[c]) + rw.lo * LANE);
  const long long o0 = static_cast<long long>(c) * a.out_cs + rw.lo * LANE;
  float m = 0.f;
  for (long long g0 = threadIdx.x; g0 < ng; g0 += STEP) {
    uint4 raw[UNROLL];
    load_trip<UNROLL, RESIDENT>(x, g0, ng, raw);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * NT;
      if (g >= ng) continue;
      float v[VEC];
      unpack16(raw[u], v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = fmaxf(m, fabsf(v[e]));
      if constexpr (RESIDENT) staged[g] = raw[u];
    }
  }
  const float s = q8_scale(rank_amax(a, m, 0, red));
  const float rs = __frcp_rn(s);
  // Pass 2, FAST a constant so that no element branches on it.
  auto stores = [&](auto fast_c) {
    constexpr bool FAST = decltype(fast_c)::value;
    for (long long g0 = threadIdx.x; g0 < ng; g0 += STEP) {
      uint4 raw[UNROLL];
      if constexpr (RESIDENT) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (g0 + u * NT < ng) raw[u] = staged[g0 + u * NT];
      } else {
        load_trip(x, g0, ng, raw);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = g0 + u * NT;
        if (g >= ng) continue;
        float v[VEC];
        unpack16(raw[u], v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = q8_dq(v[e], s, rs, FAST);
        const uint4 w = pack16(v);
#pragma unroll 4
        for (int r = 0; r < a.p; ++r)
          __stcs(reinterpret_cast<uint4*>(static_cast<T*>(a.out[r]) + o0) + g, w);
      }
    }
  };
  if (q8_fast(s)) stores(Flag<true>{});
  else stores(Flag<false>{});
}

unsigned int* g_err_host = nullptr;
unsigned int* g_err_dev = nullptr;

// The sum kernels' arguments for p ranks' [rows, 128] chunks of T.
template <typename T>
PassArgs pass_args(int p, int rows, const unsigned long long* in_ptrs,
                   const unsigned long long* out_ptrs, long long cs) {
  PassArgs a{};
  for (int r = 0; r < p; ++r) {
    a.in[r] = reinterpret_cast<const void*>(in_ptrs[r]);
    a.out[r] = reinterpret_cast<void*>(out_ptrs[r]);
  }
  a.cs = cs;
  a.n16 = static_cast<long long>(rows) * LANE * sizeof(T) / 16;
  a.p = p;
  return a;
}

// A sum kernel: one 16-byte group a thread, grid (ceil(groups /
// PASS_NT), p), so every SM holds as many blocks as it can take and the
// hardware refills them as they finish (a grid sized to the occupancy,
// striding over the groups, was no faster on this card).
template <typename K>
int launch_pass(K kernel, const PassArgs& a, cudaStream_t stream) {
  const long long nblk = (a.n16 + PASS_NT - 1) / PASS_NT;
  kernel<<<dim3(static_cast<unsigned int>(nblk), a.p), PASS_NT, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fold(const PassArgs& a, cudaStream_t stream) {
  if (a.p <= 4) return launch_pass(rs_fold_kernel<T, 4>, a, stream);
  if (a.p <= 8) return launch_pass(rs_fold_kernel<T, 8>, a, stream);
  return launch_pass(rs_fold_kernel<T, MAX_RANKS>, a, stream);
}

constexpr int MAX_DEVICES = 64;
// Shared memory a resident q8 form leaves for its static arrays and the
// per-block reserve.
constexpr int STATIC_SMEM_RESERVE = 1024;

struct Device {
  int sms = 0;
  int smem_optin = 0;     // shared memory a block may opt in to
  bool resident_ready = false;  // the resident q8 forms' opt-in is set
};
Device g_dev[MAX_DEVICES];

Device* current_device(cudaError_t* e) {
  int dev = 0;
  *e = cudaGetDevice(&dev);
  if (*e != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return nullptr;
  Device& g = g_dev[dev];
  if (g.sms == 0) {
    int sms = 0, optin = 0;
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*e == cudaSuccess)
      *e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (*e != cudaSuccess) return nullptr;
    g.sms = sms;
    g.smem_optin = optin;
  }
  return &g;
}

// Blocks a chunk for a cooperative launch: one block an SM, p chunks.
int ring_blocks(int sms, int p, int rows) {
  int nblk = sms / p;
  if (nblk > MAXB) nblk = MAXB;
  if (nblk > rows) nblk = rows;
  return nblk;
}

// The plan of a q8 form (kind 1, the q8 fold; kind 3, the q8 copy) for p
// ranks' [rows, 128] chunks of dtype: out = {form (0 resident, 1
// streaming), blocks a chunk, dynamic shared memory bytes}. Resident
// whenever a block's rows of what it keeps fit in the shared memory a
// block may take: the fold keeps the f32 partial, the copy x in its dtype.
int q8_plan(const Device& g, int kind, int dtype, int p, int rows, int out[3]) {
  const int nblk = ring_blocks(g.sms, p, rows);
  if (nblk < 1) return -1;
  const long long item = kind == 3 && dtype == 1 ? 2 : 4;
  const long long most_rows = (static_cast<long long>(rows) + nblk - 1) / nblk;
  const long long smem = most_rows * LANE * item;
  const bool resident = smem <= g.smem_optin - STATIC_SMEM_RESERVE;
  out[0] = resident ? 0 : 1;
  out[1] = nblk;
  out[2] = resident ? static_cast<int>(smem) : 0;
  return 0;
}

template <typename T>
void* q8_kernel(int kind, bool resident) {
  if (kind == 1)
    return resident ? reinterpret_cast<void*>(&rs_q8_fold_kernel<T, true>)
                    : reinterpret_cast<void*>(&rs_q8_fold_kernel<T, false>);
  return resident ? reinterpret_cast<void*>(&ag_q8_copy_kernel<T, true>)
                  : reinterpret_cast<void*>(&ag_q8_copy_kernel<T, false>);
}

// Lets the four resident kernels take all the shared memory a block may.
cudaError_t opt_in_resident(Device& g) {
  if (g.resident_ready) return cudaSuccess;
  const int most = g.smem_optin - STATIC_SMEM_RESERVE;
  for (int kind : {1, 3}) {
    for (void* fn : {q8_kernel<float>(kind, true), q8_kernel<__nv_bfloat16>(kind, true)}) {
      const cudaError_t e =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return e;
    }
  }
  g.resident_ready = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of q8 form kind (1 the q8 fold, 3 the q8 copy) for p ranks'
// [rows, 128] chunks of dtype (0 f32, 1 bf16) on the current device: out =
// {form (0 resident, 1 streaming), blocks a chunk, dynamic shared memory
// bytes}; -1 for arguments it refuses.
int mpit_q8_plan(int kind, int dtype, int p, int rows, int* out) {
  if (p < 2 || p > MAX_RANKS || rows < 1 || (kind != 1 && kind != 3) || dtype < 0 ||
      dtype > 1)
    return -1;
  cudaError_t e;
  Device* g = current_device(&e);
  if (g == nullptr) return e != cudaSuccess ? static_cast<int>(e) : -1;
  return q8_plan(*g, kind, dtype, p, rows, out);
}

// kind: 0 reduce-scatter (the fold), 1 q8 reduce-scatter (the q8 fold), 2
// all-gather (the copy), 3 q8 all-gather (the q8 copy); dtype of the input
// (and of every output but the q8 reduce-scatter's f32): 0 f32, 1 bf16. Per
// rank r: in_ptrs[r], out_ptrs[r] ([rows, 128] rows contiguous, 16-byte
// aligned; the p-chunk side's chunks in_cs / out_cs elements apart); for
// kinds 1 and 3 ws_ptrs[r] (the rank's zeroed workspace; kinds 0 and 2
// never read it, it may be null). epoch: larger than every earlier call's
// on these workspaces.
int mpit_ring_launch(int kind, int dtype, int p, int rows,
                     const unsigned long long* in_ptrs,
                     const unsigned long long* out_ptrs,
                     const unsigned long long* ws_ptrs, long long in_cs,
                     long long out_cs, unsigned long long epoch, void* stream) {
  if (p < 2 || p > MAX_RANKS || rows < 1 || kind < 0 || kind > 3 || dtype < 0 ||
      dtype > 1)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    return dtype == 0
               ? fold<float>(pass_args<float>(p, rows, in_ptrs, out_ptrs, in_cs), st)
               : fold<__nv_bfloat16>(
                     pass_args<__nv_bfloat16>(p, rows, in_ptrs, out_ptrs, in_cs), st);
  }
  if (kind == 2) {
    return dtype == 0
               ? launch_pass(ag_copy_kernel<float>,
                             pass_args<float>(p, rows, in_ptrs, out_ptrs, out_cs), st)
               : launch_pass(ag_copy_kernel<__nv_bfloat16>,
                             pass_args<__nv_bfloat16>(p, rows, in_ptrs, out_ptrs, out_cs), st);
  }
  cudaError_t e;
  Device* g = current_device(&e);
  if (g == nullptr) return e != cudaSuccess ? static_cast<int>(e) : -1;
  if (g_err_host == nullptr) {
    e = cudaHostAlloc(reinterpret_cast<void**>(&g_err_host), 64,
                      cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return static_cast<int>(e);
    *g_err_host = 0;
    e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&g_err_dev), g_err_host, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int plan[3];
  if (q8_plan(*g, kind, dtype, p, rows, plan)) return -1;
  const bool resident = plan[0] == 0;
  if (resident && (e = opt_in_resident(*g)) != cudaSuccess) return static_cast<int>(e);
  void* fn = dtype == 0 ? q8_kernel<float>(kind, resident)
                        : q8_kernel<__nv_bfloat16>(kind, resident);
  RingArgs a{};
  for (int r = 0; r < p; ++r) {
    a.in[r] = reinterpret_cast<const void*>(in_ptrs[r]);
    a.out[r] = reinterpret_cast<void*>(out_ptrs[r]);
    a.ws[r] = reinterpret_cast<u64*>(ws_ptrs[r]);
  }
  a.in_cs = in_cs;
  a.out_cs = out_cs;
  a.p = p;
  a.rows = rows;
  a.nblk = plan[1];
  a.epoch = epoch;
  a.err = g_err_dev;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(a.nblk, p), dim3(NT), args, plan[2], st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tests only: the number of i < n where the q8 fold's quotient of p[i] by
// s[i] differs from __fdiv_rn's (device arrays; *mismatches, a device
// word, is added to), on stream.
int mpit_q8_quot_mismatches(const float* p, const float* s, long long n,
                            unsigned long long* mismatches, void* stream) {
  if (n < 1) return -1;
  const long long blocks = (n + 255) / 256;
  q8_quot_check_kernel<<<static_cast<unsigned int>(blocks), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(p, s, n, mismatches);
  return static_cast<int>(cudaGetLastError());
}

// The error word a timed-out amax barrier left (0: none); readable after
// the trap.
int mpit_ring_error(void) {
  return g_err_host == nullptr ? 0 : static_cast<int>(*g_err_host);
}

const char* mpit_ring_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
