// Block-wide scans shared by the kernels of emit.cu and decode.cu.
#pragma once

namespace dxt {

struct SumOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Block-wide exclusive scan over a block of kThreads threads: returns this
// thread's exclusive prefix of x and stores the block aggregate in *total.
// s_warp holds kThreads / 32 ints of shared memory.  Every thread of the
// block must call.
template <int kThreads, class Op>
__device__ __forceinline__ int block_scan(int x, int identity, Op op, int* s_warp,
                                          int* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = op(inc, y);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : identity;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(w, y);
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(s_warp[warp - 1], excl);
  *total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is reused by the next scan
  return excl;
}

}  // namespace dxt
