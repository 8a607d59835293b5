// Ring reduce-scatter and all-gather for Hopper (sm_90a), sum and int8 wire,
// over p ranks whose buffers are named by a per-rank pointer table.
//
// Replaces the TPU kernels of mpit_tpu/ops/ring_collectives.py, all four
// reached through _call_ring (:546, pl.pallas_call at :550):
//   - rs_fold_kernel<T>   <- _rs_kernel    (:350)  sum, in x's dtype, ranks
//                                                  on one card (below)
//   - rs_q8_fold_kernel<T, RESIDENT> <- _rs_q8_kernel (:387)  int8 wire, f32
//                                                  result, ranks on one card
//                                                  (the q8 fold, below)
//   - ag_copy_kernel<T>   <- _ag_kernel    (:429)  ranks on one card (below)
//   - ag_q8_kernel<T>     <- _ag_q8_kernel (:457)  int8 wire
// The q8 all-gather runs the ring's hop schedule; the other three, with
// every rank's buffer in this card's HBM, run as one pass over HBM each
// (the q8 fold one pass a hop where its partials outgrow shared memory).
// The hop schedules of the sum forms and of the q8 reduce-scatter, for the
// launch across cards, are rebuilt with the hardware that needs it (the
// one-card hop form of the q8 reduce-scatter was removed with the fold).
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
// Launch of the hop schedule (the q8 all-gather): ONE cooperative launch carries
// all p ranks, grid (B, p):
// blockIdx.y is the rank, and block b of every rank owns rows
// [b*rows/B, (b+1)*rows/B) of every chunk, running its own sub-ring with
// block b of ranks i-1 and i+1 through its own flags. The q8 forms need the
// chunk-wide amax at every quantization: each block publishes its partial
// amax, and every block of the rank waits for all B partials and takes
// their max (exact, so order does not matter): rank_amax, the amax
// barrier, which the q8 fold shares. p*B <= the SM count and the launch is
// cooperative, so every block is resident and no spin-wait can wait on a
// block that is not running.
//
// The mailbox discipline of the TPU kernels' _Ring (:263-345), with device
// memory in place of remote DMA:
//   - a sender writes only into its right neighbour's double-buffered
//     mailbox, slot s % 2, then raises that neighbour's FULL flag for the
//     slot to this step's token;
//   - a receiver waits for its own FULL flag, reads its mailbox, and raises
//     its LEFT neighbour's CAP flag for the slot: the left may write that
//     slot again (step s + 2) only once CAP shows step s was consumed;
//   - the all-gather forwards the payload that arrived at step s - 1
//     straight from its mailbox at step s, before it releases that slot.
// Flags are never cleared: a token is epoch * 256 + step + 1, the epoch a
// per-device call counter from the wrapper, so every token is larger than
// any left over from an earlier call or bucket. Launches on one stream
// finish in order, so the neighbour barrier of _Ring.barrier reduces to
// that ordering on one device; the per-step flags are kept all the same.
//
// Memory order: a writer stores its payload, __threadfence(), then
// __syncthreads(); one thread then stores the flag with st.release.gpu. A
// reader's one thread spins with ld.acquire.gpu, __syncthreads(), and the
// block reads the mailbox through L2 (ld.global.cg): L1 is not coherent
// across SMs. In the form across cards (one launch per device, the pointer
// table naming peer buffers over NVLink) the flag stores and loads become
// .sys scope, and __threadfence() before a flag store becomes
// __threadfence_system().
//
// Every spin has a budget of clock64 cycles; when it runs out the kernel
// writes an error word into mapped host memory (readable after the context
// is lost) and traps, so a hung ring ends the launch instead of hanging it.
//
// What bounds them on this card: the function's least traffic. A
// reduce-scatter reads p chunks of every rank and writes one chunk per rank
// (p*p*c in, p*c out); an all-gather reads p*c and writes p*p*c. At
// GPT-2 small's bucket (p 4, 8192 rows of 128 f32 per chunk, 4 MiB) that
// is 80 MiB, about 0.025 ms at 3.35 TB/s. The ring schedule itself moves
// more on one HBM: every step reads and writes a chunk per rank again
// through a mailbox, since it is built for links between cards, not one
// memory. The q8 all-gather's design keeps the payload in registers
// between its loads and stores (4 elements a thread per iteration) and
// uses every SM: p*B blocks of 512 threads.
//
// The sum reduce-scatter with every rank on this one card: rs_fold_kernel,
// one pass. All p ranks share one HBM, so nothing needs to travel: for
// rank r and each element of chunk r it loads the p ranks' copies and adds
// them in the ring's own order, with the ring's own roundings:
//   acc = x[r+1][r];  for j = 2..p: acc = round_T(acc + x[r+j][r])
// (rank indices mod p; chunk r leaves rank r + 1 at step 0 and each later
// rank adds its own copy, the last being rank r's). Each add is __fadd_rn
// in f32 and is rounded to T, as a hop's partial is stored in T, so the
// result is bit-equal to the ring schedule and to the plain version
// (reduce_scatter_plain) in f32 and bf16. It moves the function's least
// traffic, the bound itself: p*p*c read once, p*c written once (80 MiB at
// GPT-2 small's f32 bucket, p 4), against about 4(p-1) + p chunk passes a
// rank for the hops. Its design is a bandwidth
// kernel's: a plain launch (no cooperative residency needed: no block waits
// on another) of blocks that fill every SM, grid (ceil(groups / 256), p)
// with blockIdx.y the rank, each thread taking one 16-byte group (4 f32 or
// 8 bf16), all p loads of the group started before the first add so p * 16
// bytes a thread are in flight, streaming loads and stores (__ldcs /
// __stcs: every byte is touched once), the group's registers sized to p
// (MAXP 4, 8 or 16). No mailbox, no flags, no epoch, no spin.
//
// The sum all-gather with every rank on this one card: ag_copy_kernel, one
// pass, of the fold's design. An all-gather is a copy: chunk c of every
// rank's output is rank c's shard. So each thread loads one 16-byte group of
// rank c's shard once (__ldcs) and stores it into chunk c of all p ranks'
// outputs, the p stores issued back to back (__stcs): p*c read, p*p*c
// written, the bound's bytes (80 MiB at p 4 f32, against the hop
// schedule's 224 MiB), in a plain launch of grid (ceil(groups / 256), p)
// with blockIdx.y the source rank c. Bit-equal to the plain version, and
// every replica holds the same bits.
//
// The q8 reduce-scatter with every rank on this one card: the q8 fold,
// rs_q8_fold_kernel. For rank r it computes the hop chain of chunk r
// directly, with the ring's roundings:
//   P_0 = f32(x[r+1][r]);  s_j = amax(P_j) / 127 over the WHOLE chunk (1 if
//   all zero);  P_j = f32(clip(rint(P_{j-1} / s_{j-1}), +-127)) * s_{j-1}
//   + f32(x[r+1+j][r]) for j = 1 .. p-1, each step rounded once (no FMA);
//   out = P_{p-1}.
// No byte needs to travel on one card: the int8 value lives only in a
// register (only dequant(quant(P)) reaches the result), so there is no
// mailbox and no FULL/CAP flag. The chunk-wide amax is the one dependency
// across blocks: a hop computes its block's amax of the new partial in the
// same pass that makes it, and the rank's blocks meet at rank_amax (its
// epoch tokens and spin budget) before the next hop. One cooperative
// launch, grid (B, p), 512 threads a block, one block an SM. Two forms,
// chosen by mpit_q8fold_plan:
//   - resident, whenever a block's rows of the f32 partial fit in the
//     shared memory a block may take (GPT-2 small's bucket at p 4: 249
//     rows, 127 KB a block): P stays in shared memory across the hops, so
//     HBM moves the bound's bytes, p*p*c*in read once and 4*p*c written
//     once;
//   - streaming, when they do not (p 8 at 8192 rows): P lives in out; hop 0
//     reads x[r+1][r] for its amax, hop 1 reads it again with x[r+2][r] and
//     writes out, each later hop reads out and x and rewrites out, all in
//     one pass a hop (the hop schedule took three).
// Each thread takes the same 16-byte groups of x at every hop, and the next
// trip's groups are in flight while a trip is computed, across the amax
// barrier too. The divide by a hop's scale is a product with its
// correctly rounded reciprocal corrected once (q8_quot), bit-equal to
// __fdiv_rn. Bit-equal to reduce_scatter_plain(quantized=True) in f32 and
// bf16 input. What holds it above the bound (PERF.md): at each of the p - 1
// barriers every block of the rank waits for the slowest, and at bf16 the
// hops' compute and the barriers outweigh the bytes.
//
// C interface for ctypes: mpit_ring_launch returns the cudaError_t of the
// launch (cudaGetLastError right after it) or -1 for arguments this file
// does not take; mpit_ring_error reads the error word, 0 if none;
// mpit_q8fold_plan names the q8 fold's form. Kinds 0, 1 and 2 are the
// one-card fold, q8 fold and copy; kind 3 the q8 ring schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 512;            // threads per block
constexpr int MAX_RANKS = 16;      // pointer-table entries
constexpr int MAXB = 256;          // blocks per rank, at most
constexpr int LANE = 128;
// Workspace of one rank, in 64-bit words (zeroed once by the wrapper):
constexpr int WS_FULL = 0;               // [2][MAXB] FULL flags
constexpr int WS_CAP = 2 * MAXB;         // [2][MAXB] CAP flags
constexpr int WS_ARRIVE = 4 * MAXB;      // [MAXB] amax-barrier flags
constexpr int WS_PART = 5 * MAXB;        // [2][MAXB] f32 partial amax
constexpr int WS_SCALE = 6 * MAXB;       // [2][MAXB] f32 scale mailbox
constexpr long long SPIN_BUDGET = 1LL << 32;  // clock64 cycles, ~2 s

typedef unsigned long long u64;

struct RingArgs {
  const void* in[MAX_RANKS];
  void* out[MAX_RANKS];
  void* mbox[MAX_RANKS];  // [2][rows][128] of the wire type
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

// Error word: kind (1 FULL, 2 CAP, 3 amax barrier) | rank << 8 | block << 16
// | step << 24, then a trap.
__device__ __noinline__ void fail(const RingArgs& a, int kind, int step) {
  *a.err = static_cast<unsigned int>(kind) | (blockIdx.y << 8) |
           (blockIdx.x << 16) | (static_cast<unsigned int>(step) << 24);
  __threadfence_system();
  __trap();
}

// One thread waits until *f >= want, within the budget.
__device__ __forceinline__ void spin(const RingArgs& a, const u64* f, u64 want,
                                     int kind, int step) {
  const long long t0 = clock64();
  while (ld_acquire(f) < want) {
    if (clock64() - t0 > SPIN_BUDGET) fail(a, kind, step);
    __nanosleep(32);
  }
}

// The whole block waits for its thread 0's spin.
__device__ __forceinline__ void block_wait(const RingArgs& a, const u64* f,
                                           u64 want, int kind, int step) {
  if (threadIdx.x == 0) {
    spin(a, f, want, kind, step);
    __threadfence();
  }
  __syncthreads();
}

// ---- four elements at a time, as float -------------------------------------

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack_bf16(uint2 x, float v[4]) {
  const __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  unpack_bf16(*reinterpret_cast<const uint2*>(p), v);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<unsigned int*>(&lo);
  x.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// int8 wire: four bytes.
__device__ __forceinline__ void load4_cg(const int8_t* p, float v[4]) {
  const char4 x = __ldcg(reinterpret_cast<const char4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void copy4_cg(const int8_t* src, int8_t* dst) {
  *reinterpret_cast<char4*>(dst) = __ldcg(reinterpret_cast<const char4*>(src));
}

// round(x / scale) half to even, clipped to +-127.
__device__ __forceinline__ void quant_store4(int8_t* p, const float v[4], float scale) {
  float r[4];
  #pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f), 127.f);
  *reinterpret_cast<char4*>(p) =
      make_char4(static_cast<signed char>(r[0]), static_cast<signed char>(r[1]),
                 static_cast<signed char>(r[2]), static_cast<signed char>(r[3]));
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

// The chunk-wide amax of one rank: this block's partial, published (the
// release store orders it before the flag), then the max over the partials
// of every block of the rank (barrier k).
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
    spin(a, ws + WS_ARRIVE + threadIdx.x, tok, 3, k);
    v = __ldcg(part + (k & 1) * MAXB + threadIdx.x);
  }
  return block_max(v, red);
}

struct Rows {
  long long r0, n4;  // first row's element offset, groups of 4 elements
};

__device__ __forceinline__ Rows my_rows(const RingArgs& a) {
  const long long lo = static_cast<long long>(blockIdx.x) * a.rows / a.nblk;
  const long long hi = static_cast<long long>(blockIdx.x + 1) * a.rows / a.nblk;
  return Rows{lo * LANE, (hi - lo) * (LANE / 4)};
}

// ---- the one-card sum reduce-scatter: one pass ------------------------------

constexpr int PASS_NT = 256;  // threads per block of the one-pass kernels

// The one-pass kernels' arguments (the fold's and the copy's).
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

// ---- the one-card q8 reduce-scatter: the q8 fold ----------------------------

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

// dequant(quant(P)) + x for one element: round(P / s) half to even, clipped
// to +-127, times s, plus x; every step rounded once, as the plain version.
__device__ __forceinline__ float q8_hop(float p, float s, float r, bool fast, float x) {
  const float q = fminf(fmaxf(rintf(q8_quot(p, s, r, fast)), -127.f), 127.f);
  return __fadd_rn(__fmul_rn(q, s), x);
}

// For the tests: counts the i < n where q8_quot(p[i], s[i]) differs in any
// bit from __fdiv_rn(p[i], s[i]), for each s[i] in the fast range.
__global__ void q8_quot_check_kernel(const float* p, const float* s, long long n,
                                     unsigned long long* mismatches) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float si = s[i];
  if (!(si >= 0x1p-100f && si <= 0x1p100f)) return;
  const float fast = q8_quot(p[i], si, __frcp_rn(si), true);
  if (__float_as_uint(fast) != __float_as_uint(__fdiv_rn(p[i], si))) atomicAdd(mismatches, 1ull);
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// A trip's UNROLL 16-byte groups of x for this thread, g0 + u * NT (u <
// UNROLL; those at or past ng are not read).
template <int UNROLL>
__device__ __forceinline__ void load_trip(const uint4* x, long long g0, long long ng,
                                          uint4 (&raw)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (g0 + u * NT < ng) raw[u] = __ldcs(x + g0 + u * NT);
}

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
  const long long lo = static_cast<long long>(blockIdx.x) * a.rows / a.nblk;
  const long long hi = static_cast<long long>(blockIdx.x + 1) * a.rows / a.nblk;
  const long long ng = (hi - lo) * LANE / VEC;  // the block's groups
  const long long x0 = static_cast<long long>(r) * a.in_cs + lo * LANE;
  float4* o = reinterpret_cast<float4*>(static_cast<float*>(a.out[r]) + lo * LANE);
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
      fast = s >= 0x1p-100f && s <= 0x1p100f;
      m = 0.f;
    }
  }
}

// ---- q8 all-gather ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) ag_q8_kernel(RingArgs a) {
  __shared__ float red[NT / 32];
  const int p = a.p, r = blockIdx.y, b = blockIdx.x;
  const int right = (r + 1) % p, left = (r + p - 1) % p;
  const Rows rw = my_rows(a);
  const long long slot_elems = static_cast<long long>(a.rows) * LANE;
  const T* x = static_cast<const T*>(a.in[r]) + rw.r0;
  T* o = static_cast<T*>(a.out[r]) + rw.r0;
  int8_t* mb_right = static_cast<int8_t*>(a.mbox[right]) + rw.r0;
  const int8_t* mb_me = static_cast<const int8_t*>(a.mbox[r]) + rw.r0;
  u64* ws_me = a.ws[r];
  float* scale_right = reinterpret_cast<float*>(a.ws[right] + WS_SCALE);
  const float* scale_me = reinterpret_cast<const float*>(ws_me + WS_SCALE);

  // The own chunk, dequantized as every receiver sees it.
  float m = 0.f;
  for (long long g = threadIdx.x; g < rw.n4; g += NT) {
    float v[4];
    load4(x + 4 * g, v);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
  }
  const float scale_own = q8_scale(rank_amax(a, m, 0, red));
  T* own = o + r * a.out_cs;
  for (long long g = threadIdx.x; g < rw.n4; g += NT) {
    float v[4];
    load4(x + 4 * g, v);
    #pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __fmul_rn(fminf(fmaxf(rintf(__fdiv_rn(v[j], scale_own)), -127.f), 127.f), scale_own);
    store4(own + 4 * g, v);
  }
  for (int s = 0; s < p - 1; ++s) {
    const int recv_c = (r - 1 - s + 2 * p) % p;
    const int slot = s & 1;
    if (s >= 2) block_wait(a, ws_me + WS_CAP + slot * MAXB + b, token(a, s - 2), 2, s);
    int8_t* dst = mb_right + slot * slot_elems;
    if (s == 0) {
      for (long long g = threadIdx.x; g < rw.n4; g += NT) {
        float v[4];
        load4(x + 4 * g, v);
        quant_store4(dst + 4 * g, v, scale_own);
      }
      if (threadIdx.x == 0) scale_right[slot * MAXB + b] = scale_own;
    } else {  // forward what arrived at step s - 1, verbatim
      const int8_t* prev = mb_me + (slot ^ 1) * slot_elems;
      #pragma unroll 4
      for (long long g = threadIdx.x; g < rw.n4; g += NT) copy4_cg(prev + 4 * g, dst + 4 * g);
      if (threadIdx.x == 0)
        scale_right[slot * MAXB + b] = __ldcg(scale_me + (slot ^ 1) * MAXB + b);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      st_release(a.ws[right] + WS_FULL + slot * MAXB + b, token(a, s));
      // The slot of step s - 1 has been forwarded; the left may reuse it.
      if (s >= 1) st_release(a.ws[left] + WS_CAP + (slot ^ 1) * MAXB + b, token(a, s - 1));
    }
    block_wait(a, ws_me + WS_FULL + slot * MAXB + b, token(a, s), 1, s);
    const float in_scale = __ldcg(scale_me + slot * MAXB + b);
    const int8_t* src = mb_me + slot * slot_elems;
    T* dst_o = o + recv_c * a.out_cs;
    #pragma unroll 4
    for (long long g = threadIdx.x; g < rw.n4; g += NT) {
      float w[4];
      load4_cg(src + 4 * g, w);
      #pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = __fmul_rn(w[j], in_scale);
      store4(dst_o + 4 * g, w);
    }
    if (s == p - 2) {
      __syncthreads();
      if (threadIdx.x == 0) st_release(a.ws[left] + WS_CAP + slot * MAXB + b, token(a, s));
    }
  }
}

unsigned int* g_err_host = nullptr;
unsigned int* g_err_dev = nullptr;

// The one-pass kernels' arguments for p ranks' [rows, 128] chunks of T.
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

// A one-pass kernel: one 16-byte group a thread, grid (ceil(groups /
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
// Shared memory the resident fold leaves for its static arrays and the
// per-block reserve.
constexpr int STATIC_SMEM_RESERVE = 1024;

struct Device {
  int sms = 0;
  int smem_optin = 0;     // shared memory a block may opt in to
  bool resident_ready = false;  // the resident fold's opt-in is set
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

// Blocks a rank for a cooperative ring launch: one block an SM, p ranks.
int ring_blocks(int sms, int p, int rows) {
  int nblk = sms / p;
  if (nblk > MAXB) nblk = MAXB;
  if (nblk > rows) nblk = rows;
  return nblk;
}

// The q8 fold's plan: out = {form (0 resident, 1 streaming), blocks a rank,
// dynamic shared memory bytes}. Resident whenever a block's rows of the f32
// partial fit in the shared memory a block may take.
int q8fold_plan(const Device& g, int p, int rows, int out[3]) {
  const int nblk = ring_blocks(g.sms, p, rows);
  if (nblk < 1) return -1;
  const long long most_rows = (static_cast<long long>(rows) + nblk - 1) / nblk;
  const long long smem = most_rows * LANE * static_cast<long long>(sizeof(float));
  const bool resident = smem <= g.smem_optin - STATIC_SMEM_RESERVE;
  out[0] = resident ? 0 : 1;
  out[1] = nblk;
  out[2] = resident ? static_cast<int>(smem) : 0;
  return 0;
}

template <typename T>
void* q8fold_kernel(bool resident) {
  return resident ? reinterpret_cast<void*>(&rs_q8_fold_kernel<T, true>)
                  : reinterpret_cast<void*>(&rs_q8_fold_kernel<T, false>);
}

}  // namespace

extern "C" {

// The q8 fold's plan for p ranks' [rows, 128] chunks on the current device:
// out = {form (0 resident, 1 streaming), blocks a rank, dynamic shared
// memory bytes}; -1 for arguments it refuses.
int mpit_q8fold_plan(int p, int rows, int* out) {
  if (p < 2 || p > MAX_RANKS || rows < 1) return -1;
  cudaError_t e;
  Device* g = current_device(&e);
  if (g == nullptr) return e != cudaSuccess ? static_cast<int>(e) : -1;
  return q8fold_plan(*g, p, rows, out);
}

// kind: 0 reduce-scatter (the one-pass fold), 1 q8 reduce-scatter (the q8
// fold), 2 all-gather (the one-pass copy), 3 q8 all-gather (the hop
// schedule); dtype of the input (and of every output but the q8
// reduce-scatter's f32): 0 f32, 1 bf16. Per rank r: in_ptrs[r], out_ptrs[r]
// ([rows, 128] rows contiguous, 16-byte aligned; the p-chunk side's chunks
// in_cs / out_cs elements apart); for kinds 1 and 3 ws_ptrs[r] (the rank's
// zeroed workspace), and for kind 3 mbox_ptrs[r] ([2][rows][128] int8); a
// kind never reads the tables it does not take (they may be null).
// epoch: larger than every earlier call's on these workspaces.
int mpit_ring_launch(int kind, int dtype, int p, int rows,
                     const unsigned long long* in_ptrs,
                     const unsigned long long* out_ptrs,
                     const unsigned long long* mbox_ptrs,
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
  int nblk = ring_blocks(g->sms, p, rows);
  if (nblk < 1) return -1;
  void* fn;
  int smem = 0;
  if (kind == 1) {
    int plan[3];
    if (q8fold_plan(*g, p, rows, plan)) return -1;
    const bool resident = plan[0] == 0;
    nblk = plan[1];
    smem = plan[2];
    if (resident && !g->resident_ready) {
      const int most = g->smem_optin - STATIC_SMEM_RESERVE;
      e = cudaFuncSetAttribute(q8fold_kernel<float>(true),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(q8fold_kernel<__nv_bfloat16>(true),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return static_cast<int>(e);
      g->resident_ready = true;
    }
    fn = dtype == 0 ? q8fold_kernel<float>(resident) : q8fold_kernel<__nv_bfloat16>(resident);
  } else {
    fn = dtype == 0 ? reinterpret_cast<void*>(&ag_q8_kernel<float>)
                    : reinterpret_cast<void*>(&ag_q8_kernel<__nv_bfloat16>);
  }
  RingArgs a{};
  for (int r = 0; r < p; ++r) {
    a.in[r] = reinterpret_cast<const void*>(in_ptrs[r]);
    a.out[r] = reinterpret_cast<void*>(out_ptrs[r]);
    a.mbox[r] = kind == 3 ? reinterpret_cast<void*>(mbox_ptrs[r]) : nullptr;
    a.ws[r] = reinterpret_cast<u64*>(ws_ptrs[r]);
  }
  a.in_cs = in_cs;
  a.out_cs = out_cs;
  a.p = p;
  a.rows = rows;
  a.nblk = nblk;
  a.epoch = epoch;
  a.err = g_err_dev;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(nblk, p), dim3(NT), args, smem, st);
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

// The error word a timed-out spin left (0: none); readable after the trap.
int mpit_ring_error(void) {
  return g_err_host == nullptr ? 0 : static_cast<int>(*g_err_host);
}

const char* mpit_ring_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
