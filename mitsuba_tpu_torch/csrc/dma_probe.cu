// Device-memory copy probe (kernel K4): the rate at which blocks stream
// windows of a large array from device memory into shared memory.
//
// Replaces the TPU kernel of scripts/bench_dma.py (`kernel` in make_bench,
// a ring of async copies from HBM into VMEM). Contract (see
// ops/dma_probe.py): x [T, 128] float32; copy i moves the window of `rows`
// rows starting at row (i * 7919) mod (T - rows), i = 0 .. n_copies - 1;
// after a copy has landed, the first element of its window is added to a
// sink. Out: one int64 partial sum per block (the windows' first elements,
// whole numbers in the probe's data, so the sum is exact).
//
// What bounds it on an H100: bytes, by design: each copy is rows * 512 B
// read from device memory, at most 3.35 TB/s, and nothing is computed. The
// array is 128 MiB, more than the 50 MB L2, but a window may still be met
// in L2 by a nearby earlier one, so the rate is of device memory and L2
// together (scripts/torch_bench_dma.py reports it as such).
//
// Design: the TPU kernel is one core with one ring. Here every block has
// its own ring of `Ring` window buffers in dynamic shared memory, and copy i
// belongs to block i mod gridDim.x, so that the copies are spread over all
// SMs; the grid is as many blocks as fit on the card at once. Each thread
// moves its share of a window as 16-byte cp.async.cg copies (through L2,
// not L1), one commit group a window; at window k the block waits with
// cp.async.wait_group Ring - 1 for window k - Ring + 1, synchronises, and
// one thread adds that window's first element. A second barrier keeps the
// buffer from being refilled before it was read. Unlike the TPU kernel,
// whose sink reads a buffer before its copy's wait, the sink reads only
// data that has landed, so it is well defined and checked exactly against
// the plain version (a gather of the same offsets).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowFloats = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int Ring>
__global__ void __launch_bounds__(kThreads)
copy_probe_kernel(const float* __restrict__ x, long long total_rows, int rows,
                  long long n_copies, long long* __restrict__ sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bytes = rows * kRowFloats * 4;
  const int pieces = bytes / 16;
  const long long span = total_rows - rows;
  const long long first = blockIdx.x;
  const long long step = gridDim.x;
  const long long mine = first < n_copies ? (n_copies - 1 - first) / step + 1 : 0;
  long long acc = 0;
  for (long long k = 0; k < mine + Ring - 1; ++k) {
    if (k < mine) {
      const long long i = first + k * step;
      const long long off = (i * 7919) % span;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x + off * kRowFloats);
      unsigned char* dst = smem + (k % Ring) * bytes;
      for (int p = threadIdx.x; p < pieces; p += kThreads) {
        cp_async16(dst + 16 * p, src + 16 * p);
      }
    }
    // one group per step, empty in the drain, so that wait_group counts
    // windows
    commit_group();
    if (k >= Ring - 1) {
      wait_group<Ring - 1>();
      __syncthreads();
      if (threadIdx.x == 0) {
        const long long j = k - (Ring - 1);
        acc += static_cast<long long>(
            reinterpret_cast<const float*>(smem + (j % Ring) * bytes)[0]);
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) sink[blockIdx.x] = acc;
}

template <int Ring>
int launch(const float* x, long long total_rows, int rows, long long n_copies,
           long long* sink, int max_blocks, int* blocks_out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Ring) * rows * kRowFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(copy_probe_kernel<Ring>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_probe_kernel<Ring>,
                                                           kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int blocks = sms * per_sm;
  if (blocks > max_blocks) blocks = max_blocks;
  *blocks_out = blocks;
  copy_probe_kernel<Ring><<<blocks, kThreads, smem, stream>>>(x, total_rows, rows,
                                                              n_copies, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` with as many blocks as fit on the card (at most
// max_blocks, the length of `sink`), writes that count to *blocks_out and
// returns the first CUDA error of the set-up or the launch. ring is 2, 3 or
// 4; rows * 512 must be a multiple of 16.
extern "C" int copy_probe_launch(const float* x, long long total_rows, int rows,
                                 int ring, long long n_copies, long long* sink,
                                 int max_blocks, int* blocks_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ring) {
    case 2: return launch<2>(x, total_rows, rows, n_copies, sink, max_blocks, blocks_out, s);
    case 3: return launch<3>(x, total_rows, rows, n_copies, sink, max_blocks, blocks_out, s);
    case 4: return launch<4>(x, total_rows, rows, n_copies, sink, max_blocks, blocks_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
