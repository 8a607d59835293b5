// Whole-buffer byte copy for Hopper (sm_90a): the KV shipment's transfer.
//
// Replaces the TPU kernel of mpit_tpu/serve/shipment.py: _ship_kernel (:301),
// reached through ship_kv_remote (:284, pl.pallas_call at :313). That kernel
// runs one make_async_remote_copy of a whole buffer (any dtype, any shape)
// into an output of the same shape on logical device dst_device, start() then
// wait() on a send and a receive DMA semaphore. Its consumers are the fleet's
// KV shipments: the prefill worker's packed payload moves to a decode worker
// without a trip through host memory.
//
// What it computes: dst[i] = src[i] for every byte i < n, bit for bit. Here
// both buffers are on this card; the wait() is the kernel's end on the
// stream: every later launch on the same stream sees the bytes.
//
// Ordering across the fleet's threads: the compat simulator delivers a
// message on the sender's thread, under the receiver's mailbox lock, and the
// receiver reads the buffer later on its own thread. Every thread of the port
// launches on the device's default stream (the port creates no
// torch.cuda.Stream), so stream order alone puts the copy before every read
// that follows it. If a worker ever runs on a side stream, the delivery must
// record an event that the receiver's stream waits on.
//
// What bounds it on this card: bytes. It reads n and writes n, nothing else:
// 2 n / 3.35 TB/s, 2.8 us for GPT-2 small's 4.72 MB bf16 shipment. One
// load-store body, every thread's loads issued before its first store, in
// two shapes that a plan (mpit_kv_ship_plan) picks by size:
//   - wave (below STREAM_FROM_BYTES, the fleet's shipments): WAVE_WORDS
//     words a thread, the grid sized from n up to the SM's full residency
//     (2048 threads; past that the threads stride over the rest), loads and
//     stores streaming (__ldcs / __stcs), so a shipment of a few MB is one
//     wave with every load in flight;
//   - stream (large buffers): one word a thread, a block per STREAM_NT
//     words, plain loads and stores, the hardware refilling each SM as
//     blocks finish (at 256 MiB this read faster than the wave shape and
//     than copy_; the wave shape read faster at the shipments' sizes).
// Words are 16-byte vectors, neighbouring threads on neighbouring
// addresses. A head of up to 15 bytes brings src to a 16-byte boundary and
// a tail of up to 15 bytes finishes, one byte a thread. When src and dst
// are misaligned against each other (their addresses differ by other than
// a multiple of 16), the widest word that both reach together (8, 4, 2 or 1
// bytes) takes the vector's place, with a head and tail of the same kind.
// A bulk-copy body (cp.async.bulk global -> shared -> global through a ring
// of stages, one thread a block) was tried on the H100 and read no faster
// than these at the shipments' sizes and slower at 256 MiB; it is not kept.
//
// C interface for ctypes: mpit_kv_ship returns the cudaError_t of the launch
// (cudaGetLastError right after it), or -1 for arguments it refuses.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WAVE_NT = 256;      // wave: threads a block
constexpr int WAVE_WORDS = 4;     // wave: words a thread has in flight a trip
constexpr int SM_THREADS = 2048;  // resident threads an SM
constexpr int STREAM_NT = 512;    // stream: threads a block, a word each
constexpr long long STREAM_FROM_BYTES = 32LL << 20;
constexpr int MAX_DEVICES = 64;
// Shapes, as mpit_kv_ship_plan names them.
constexpr int SHAPE_WAVE = 0;
constexpr int SHAPE_STREAM = 1;

typedef unsigned char u8;

// WORDS words a thread a trip (all its loads issued before its stores),
// trips striding over the grid; STREAMING: evict-first loads and stores.
template <typename W, int NT, int WORDS, bool STREAMING>
__global__ void __launch_bounds__(NT) ship_kernel(const u8* __restrict__ src,
                                                  u8* __restrict__ dst, long long n,
                                                  int head) {
  const long long tid = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  // Head: the bytes before src + head, which is W-aligned (and so is
  // dst + head: the caller picked W from the two addresses' difference).
  if (tid < head) dst[tid] = src[tid];
  const long long words = (n - head) / static_cast<long long>(sizeof(W));
  const W* s = reinterpret_cast<const W*>(src + head);
  W* d = reinterpret_cast<W*>(dst + head);
  for (long long base = tid; base < words; base += WORDS * stride) {
    W v[WORDS];
#pragma unroll
    for (int u = 0; u < WORDS; ++u) {
      const long long i = base + u * stride;
      if (i < words) v[u] = STREAMING ? __ldcs(s + i) : s[i];
    }
#pragma unroll
    for (int u = 0; u < WORDS; ++u) {
      const long long i = base + u * stride;
      if (i >= words) continue;
      if (STREAMING) __stcs(d + i, v[u]);
      else d[i] = v[u];
    }
  }
  // Tail: fewer than sizeof(W) bytes past the last whole word.
  const long long t = head + words * static_cast<long long>(sizeof(W)) + tid;
  if (tid < static_cast<long long>(sizeof(W)) && t < n) dst[t] = src[t];
}

int g_sms[MAX_DEVICES];

// The word both addresses reach at the same offset (16, 8, 4, 2 or 1).
int word_bytes(uintptr_t src, uintptr_t dst) {
  const uintptr_t skew = dst - src;
  for (int w = 16; w > 1; w >>= 1)
    if (skew % w == 0) return w;
  return 1;
}

int head_bytes(uintptr_t src, long long n, int w) {
  int head = static_cast<int>((w - src % w) % w);
  return head > n ? static_cast<int>(n) : head;
}

// Shape, word and blocks for n bytes from src to dst on a card of sms SMs;
// shape < 0 asks for the plan's choice, else that shape.
void plan(uintptr_t src, uintptr_t dst, long long n, int sms, int shape, int out[3]) {
  const int w = word_bytes(src, dst);
  if (shape < 0) shape = n >= STREAM_FROM_BYTES ? SHAPE_STREAM : SHAPE_WAVE;
  const long long words = (n - head_bytes(src, n, w)) / w;
  long long blocks;
  if (shape == SHAPE_STREAM) {
    blocks = (words + STREAM_NT - 1) / STREAM_NT;
  } else {
    blocks = (words + WAVE_NT * WAVE_WORDS - 1) / (WAVE_NT * WAVE_WORDS);
    const long long cap = static_cast<long long>(sms) * (SM_THREADS / WAVE_NT);
    if (blocks > cap) blocks = cap;
  }
  out[0] = shape;
  out[1] = w;
  out[2] = static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename W>
void launch(const u8* s, u8* d, long long n, const int p[3], cudaStream_t st) {
  const int head = head_bytes(reinterpret_cast<uintptr_t>(s), n, sizeof(W));
  if (p[0] == SHAPE_STREAM)
    ship_kernel<W, STREAM_NT, 1, false><<<p[2], STREAM_NT, 0, st>>>(s, d, n, head);
  else
    ship_kernel<W, WAVE_NT, WAVE_WORDS, true><<<p[2], WAVE_NT, 0, st>>>(s, d, n, head);
}

// The SM count of device dev, read once; 0 if refused.
int sm_count(int dev, cudaError_t* e) {
  *e = cudaSuccess;
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  if (g_sms[dev] == 0) {
    int sms = 0;
    *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*e != cudaSuccess) return 0;
    g_sms[dev] = sms;
  }
  return g_sms[dev];
}

}  // namespace

extern "C" {

// The plan for nbytes from src to dst on device dev: out = {shape (0 wave,
// 1 stream), word bytes, blocks}; shape < 0: the plan's choice, else that
// shape.
int mpit_kv_ship_plan(const void* src, const void* dst, long long nbytes, int shape, int dev,
                      int* out) {
  if (nbytes < 1 || shape > SHAPE_STREAM) return -1;
  cudaError_t e;
  const int sms = sm_count(dev, &e);
  if (sms == 0) return e != cudaSuccess ? static_cast<int>(e) : -1;
  plan(reinterpret_cast<uintptr_t>(src), reinterpret_cast<uintptr_t>(dst), nbytes, sms, shape,
       out);
  return 0;
}

// Copy nbytes from src to dst (device pointers on device dev, the ranges not
// overlapping) on stream, in the shape mpit_kv_ship_plan names for shape.
// The launch is made on dev, and the calling thread's current device is
// left as it was.
int mpit_kv_ship(const void* src, void* dst, long long nbytes, int shape, int dev,
                 void* stream) {
  if (nbytes < 0 || (nbytes > 0 && (src == nullptr || dst == nullptr)) || shape > SHAPE_STREAM)
    return -1;
  if (nbytes == 0) return 0;
  cudaError_t e;
  const int sms = sm_count(dev, &e);
  if (sms == 0) return e != cudaSuccess ? static_cast<int>(e) : -1;
  const auto* s = static_cast<const u8*>(src);
  auto* d = static_cast<u8*>(dst);
  int p[3];
  plan(reinterpret_cast<uintptr_t>(s), reinterpret_cast<uintptr_t>(d), nbytes, sms, shape, p);
  int cur = 0;
  e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != dev) e = cudaSetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (p[1]) {
    case 16: launch<uint4>(s, d, nbytes, p, st); break;
    case 8: launch<uint2>(s, d, nbytes, p, st); break;
    case 4: launch<unsigned int>(s, d, nbytes, p, st); break;
    case 2: launch<unsigned short>(s, d, nbytes, p, st); break;
    default: launch<unsigned char>(s, d, nbytes, p, st); break;
  }
  e = cudaGetLastError();
  if (cur != dev) cudaSetDevice(cur);
  return static_cast<int>(e);
}

const char* mpit_kv_ship_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
