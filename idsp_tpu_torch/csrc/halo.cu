// K41: the ring put of `halo_exchange_prev_rdma`.  Rank r stores the last
// h rows of its block into the receive slot of rank (r + 1) mod P through
// a CUDA IPC mapping of that rank's memory, then raises the peer's arrival
// flag; every rank waits for its own flag and copies its slot out.
//
// Replaces the Pallas kernel of idsp_tpu/parallel/halo_rdma.py
// `halo_exchange_prev_rdma` (:30, pallas_call :80): the neighbour barrier
// semaphore (:55-65) becomes a "slot free" flag that the receiver raises
// after it copied its halo out, and `make_async_remote_copy` with its
// send/recv DMA semaphores (:67-76) becomes stores into the peer's slot,
// `__threadfence_system()`, and a release store of the peer's arrival
// flag at system scope.
//
// The slots.  Each rank owns one cudaMalloc allocation per (group, byte
// size), made by `idsp_halo_slot_alloc` (not torch's caching allocator:
// an IPC handle names the base of an allocation) and shared through
// `cudaIpcGetMemHandle` / `cudaIpcOpenMemHandle`.  Layout: kMaxBlocks
// arrival flags, kMaxBlocks slot-free flags (uint64 each), then the data
// at kDataOffset.  Flags hold monotone epochs (call 1, 2, ...), never
// booleans, so no reset can race with the next put: a put of epoch e
// waits until the peer's slot-free flag reads e - 1 or more, and a
// receive waits until its arrival flag reads e or more.
//
// Blocks.  The bytes are cut into one chunk per block at a fixed 16-byte
// granularity, the same on every rank whatever the copy width, and block
// b of a rank talks only to block b of its neighbours through flag b.  No
// block waits on another block of its own grid, so the grid needs no
// co-residency, and no rank's put waits on anything of the current epoch.
//
// Waiting.  Thread 0 of a block spins on an acquire load (`ld.acquire.sys`)
// bounded by `%globaltimer` (timeout_ns, a few seconds): processes that
// share one card take turns on it (time slicing), so a neighbour's put can
// be a few time slices away.  On timeout the block writes an error word
// (1: the right neighbour never freed its slot, 2: nothing arrived) and
// leaves; the wrapper reads the word after the launch and raises.  The
// slot is read with `__ldcg` (at L2, coherent for the writes of another
// process on the same card and for NVLink peer stores).
//
// What bounds it on the H100: latency, not bytes.  The least time for the
// bytes is 2 h row_bytes / 3.35 TB/s (under a microsecond for the halos of
// the main path); the flag round trips across processes (time slices on
// one card) or NVLink dominate.  The design keeps the copy simple: 16-byte
// words where every pointer and the size allow, one chunk per block.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 64;  // flags per slot
constexpr long long kDataOffset = 4096;  // after 2 kMaxBlocks uint64 flags
constexpr long long kGrain = 16;  // chunk boundaries, bytes

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= want; false once the deadline (ns) has passed.
__device__ bool wait_geq(const unsigned long long* flag,
                         unsigned long long want,
                         unsigned long long deadline) {
  while (ld_acquire_sys(flag) < want) {
    if (global_ns() > deadline) return false;
    __nanosleep(128);
  }
  return true;
}

// V: the copy word (uint4, uint2, unsigned int or unsigned char); every
// pointer and the byte count are multiples of sizeof(V).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    halo_put_kernel(const unsigned char* __restrict__ src,
                    unsigned char* __restrict__ out, unsigned char* my_base,
                    unsigned char* peer_base, long long nbytes,
                    long long chunk, unsigned long long epoch,
                    unsigned long long timeout_ns, int* err) {
  const int b = blockIdx.x;
  const long long lo = b * chunk;
  const long long hi = lo + chunk < nbytes ? lo + chunk : nbytes;
  const long long n = hi > lo ? (hi - lo) / static_cast<long long>(sizeof(V))
                              : 0;
  auto* my_flags = reinterpret_cast<unsigned long long*>(my_base);
  auto* peer_flags = reinterpret_cast<unsigned long long*>(peer_base);
  const V* from = reinterpret_cast<const V*>(src + lo);
  V* to_peer = reinterpret_cast<V*>(peer_base + kDataOffset + lo);
  const V* slot = reinterpret_cast<const V*>(my_base + kDataOffset + lo);
  V* to_out = reinterpret_cast<V*>(out + lo);
  __shared__ int ok;
  unsigned long long deadline = 0;

  // 1. neighbour barrier: the right neighbour copied out epoch - 1
  if (threadIdx.x == 0) {
    deadline = global_ns() + timeout_ns;
    ok = wait_geq(peer_flags + kMaxBlocks + b, epoch - 1, deadline);
    if (!ok) atomicMax(err, 1);
  }
  __syncthreads();
  if (!ok) return;
  // 2. put this block's chunk into the peer's slot
  for (long long i = threadIdx.x; i < n; i += kThreads) to_peer[i] = from[i];
  __threadfence_system();
  __syncthreads();
  // 3. signal, then 4. wait for the left neighbour's put
  if (threadIdx.x == 0) {
    st_release_sys(peer_flags + b, epoch);
    ok = wait_geq(my_flags + b, epoch, deadline);
    if (!ok) atomicMax(err, 2);
  }
  __syncthreads();
  if (!ok) return;
  for (long long i = threadIdx.x; i < n; i += kThreads)
    to_out[i] = __ldcg(slot + i);
  __syncthreads();
  // the slot is free for epoch + 1
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(my_flags + kMaxBlocks + b, epoch);
  }
}

template <typename V>
cudaError_t launch(const void* src, void* out, void* my_base,
                   void* peer_base, long long nbytes, long long chunk,
                   int blocks, long long epoch, long long timeout_ns,
                   int* err, cudaStream_t stream) {
  halo_put_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(src),
      static_cast<unsigned char*>(out), static_cast<unsigned char*>(my_base),
      static_cast<unsigned char*>(peer_base), nbytes, chunk,
      static_cast<unsigned long long>(epoch),
      static_cast<unsigned long long>(timeout_ns), err);
  return cudaGetLastError();
}

}  // namespace

// A zeroed slot of `slot_bytes` data bytes on the current device and its
// IPC handle (64 bytes into `handle`).
extern "C" int idsp_halo_slot_alloc(long long slot_bytes, void** base,
                                    void* handle) {
  if (slot_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* p = nullptr;
  cudaError_t e = cudaMalloc(&p, kDataOffset + slot_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemset(p, 0, kDataOffset + slot_bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (e == cudaSuccess) e = cudaIpcGetMemHandle(&h, p);
  if (e != cudaSuccess) {
    cudaFree(p);
    return static_cast<int>(e);
  }
  for (unsigned i = 0; i < sizeof(h); ++i)
    static_cast<char*>(handle)[i] = h.reserved[i];
  *base = p;
  return 0;
}

// Map another process's slot (never one of this process: CUDA refuses).
extern "C" int idsp_halo_slot_open(const void* handle, void** base) {
  cudaIpcMemHandle_t h;
  for (unsigned i = 0; i < sizeof(h); ++i)
    h.reserved[i] = static_cast<const char*>(handle)[i];
  return static_cast<int>(
      cudaIpcOpenMemHandle(base, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int idsp_halo_slot_close(void* base) {
  return static_cast<int>(cudaIpcCloseMemHandle(base));
}

extern "C" int idsp_halo_slot_free(void* base) {
  return static_cast<int>(cudaFree(base));
}

// The largest number of blocks of a put (the flags of a slot).
extern "C" int idsp_halo_max_blocks() { return kMaxBlocks; }

// One put + wait of `nbytes` from `src` (this rank's tail) to `out` (the
// left neighbour's tail), on `stream`.  `peer_base` is the right
// neighbour's slot (this rank's own for a ring of one).
extern "C" int idsp_halo_put(const void* src, void* out, void* my_base,
                             void* peer_base, long long nbytes, int blocks,
                             long long epoch, long long timeout_ns, void* err,
                             void* stream) {
  if (nbytes <= 0 || blocks < 1 || blocks > kMaxBlocks || epoch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long chunk = (nbytes + blocks - 1) / blocks;
  chunk = (chunk + kGrain - 1) / kGrain * kGrain;
  const auto addr = reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(out) |
                    static_cast<uintptr_t>(nbytes);
  auto s = static_cast<cudaStream_t>(stream);
  auto* e = static_cast<int*>(err);
  cudaError_t r;
  if (addr % 16 == 0)
    r = launch<uint4>(src, out, my_base, peer_base, nbytes, chunk, blocks,
                      epoch, timeout_ns, e, s);
  else if (addr % 8 == 0)
    r = launch<uint2>(src, out, my_base, peer_base, nbytes, chunk, blocks,
                      epoch, timeout_ns, e, s);
  else if (addr % 4 == 0)
    r = launch<unsigned int>(src, out, my_base, peer_base, nbytes, chunk,
                             blocks, epoch, timeout_ns, e, s);
  else
    r = launch<unsigned char>(src, out, my_base, peer_base, nbytes, chunk,
                              blocks, epoch, timeout_ns, e, s);
  return static_cast<int>(r);
}
