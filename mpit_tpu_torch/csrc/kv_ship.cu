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
// 2 n / 3.35 TB/s, 2.8 us for GPT-2 small's 4.72 MB bf16 shipment. The design:
//   - the body moves 16-byte vectors (uint4) in a grid-stride loop, neighbouring
//     threads on neighbouring addresses, four vectors in flight a thread;
//   - a head of up to 15 bytes brings src to a 16-byte boundary and a tail of
//     up to 15 bytes finishes, one byte a thread, masked;
//   - when src and dst are misaligned against each other (their addresses
//     differ by other than a multiple of 16), the widest word that both can
//     reach together (8, 4, 2 or 1 bytes) takes the vector's place, with a
//     head and tail of the same kind;
//   - the grid is at most 4 blocks of 256 threads a streaming multiprocessor.
// A TMA bulk copy and a tuned grid are later work.
//
// C interface for ctypes: mpit_kv_ship returns the cudaError_t of the launch
// (cudaGetLastError right after it), or -1 for arguments it refuses.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_DEVICES = 64;

template <typename W>
__global__ void __launch_bounds__(NT) ship_kernel(const unsigned char* __restrict__ src,
                                                  unsigned char* __restrict__ dst,
                                                  long long n, int head) {
  const long long tid = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  // Head: the bytes before src + head, which is W-aligned (and so is
  // dst + head: the caller picked W from the two addresses' difference).
  if (tid < head) dst[tid] = src[tid];
  const long long words = (n - head) / static_cast<long long>(sizeof(W));
  const W* s = reinterpret_cast<const W*>(src + head);
  W* d = reinterpret_cast<W*>(dst + head);
  long long i = tid;
  for (; i + 3 * stride < words; i += 4 * stride) {
    const W a = s[i];
    const W b = s[i + stride];
    const W c = s[i + 2 * stride];
    const W e = s[i + 3 * stride];
    d[i] = a;
    d[i + stride] = b;
    d[i + 2 * stride] = c;
    d[i + 3 * stride] = e;
  }
  for (; i < words; i += stride) d[i] = s[i];
  // Tail: fewer than sizeof(W) bytes past the last whole word.
  const long long t = head + words * static_cast<long long>(sizeof(W)) + tid;
  if (tid < static_cast<long long>(sizeof(W)) && t < n) dst[t] = src[t];
}

int g_sms[MAX_DEVICES];

template <typename W>
cudaError_t launch(const unsigned char* src, unsigned char* dst, long long n, int sms,
                   cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int head = static_cast<int>((sizeof(W) - a % sizeof(W)) % sizeof(W));
  if (head > n) head = static_cast<int>(n);
  const long long words = (n - head) / static_cast<long long>(sizeof(W));
  long long blocks = (words + NT - 1) / NT;
  if (blocks > static_cast<long long>(sms) * BLOCKS_PER_SM) blocks = sms * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  ship_kernel<W><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(src, dst, n, head);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (device pointers on the current device, the
// ranges not overlapping) on stream.
int mpit_kv_ship(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes < 0 || (nbytes > 0 && (src == nullptr || dst == nullptr))) return -1;
  if (nbytes == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES) return -1;
  if (g_sms[dev] == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_sms[dev] = sms;
  }
  const auto* s = static_cast<const unsigned char*>(src);
  auto* d = static_cast<unsigned char*>(dst);
  const auto st = static_cast<cudaStream_t>(stream);
  // The widest word both addresses reach at the same offset.
  const uintptr_t skew = reinterpret_cast<uintptr_t>(d) - reinterpret_cast<uintptr_t>(s);
  const int sms = g_sms[dev];
  if (skew % 16 == 0) e = launch<uint4>(s, d, nbytes, sms, st);
  else if (skew % 8 == 0) e = launch<uint2>(s, d, nbytes, sms, st);
  else if (skew % 4 == 0) e = launch<unsigned int>(s, d, nbytes, sms, st);
  else if (skew % 2 == 0) e = launch<unsigned short>(s, d, nbytes, sms, st);
  else e = launch<unsigned char>(s, d, nbytes, sms, st);
  return static_cast<int>(e);
}

const char* mpit_kv_ship_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
