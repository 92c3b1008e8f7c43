// Hand-written Hopper kernel (sm_90a) of the delTag route.
//
//   dxt_tag_route  K10, replaces dextractor_tpu/ops/tag_pallas.py::tag_route_rows
//
// What it computes is the Pallas kernel's function (tag_pallas.py:33-63), the
// reference's Unpack_Tag (QV.c:824-847) by kept-rank gather: every position
// of a row carries one int32 of state, rank << 2 | kept << 1 | in_read (rank:
// the position's kept rank).  A kept position becomes the letter acgt[code]
// of packed code ``rank``: byte (rank >> 2) & 3 of the row's little-endian
// u32 word rank >> 4, bits 7-6 for the first code of a byte (DB.c:334); an
// in-read hole becomes 'n'; anything else 0.  A word index outside the row's
// TBW words reads as 0 (the letter 'a'), as the Pallas select over its
// zero-padded words gives; the kernel never reads past a row.  The plain
// PyTorch twin (ops/tag.py::tag_route_rows_ref) computes the same function;
// chip_smoke.py holds the kernel against it bit for bit.
//
// None of the TPU blocking carries over: no 8x128 VREG chunks, no loop over
// 128-word slices of the lane gather, no padding of the rows to 64.  Bound on
// the H100: by bytes.  Each position reads its 4-byte state and writes one
// byte; the word it needs is shared by the 16 kept positions of one rank run
// and comes through the read-only cache, so the words cost about their own
// bytes once.  Design: one thread per four output columns (one 16-byte state
// load and one 4-byte store when the row width is a multiple of 4 and the
// state is 16-byte aligned, else four single loads and stores), blocks of 512
// columns, the grid over rows (x) and column blocks (y).  Rows of any width
// and any TBW; a rank up to 2^29 - 1 fits the state.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4 * kThreads;        // columns of one block
constexpr long long kMaxColBlocks = 65535;  // the grid's y dimension

__device__ __forceinline__ uint32_t route(int st, const uint32_t* __restrict__ words,
                                          long long tbw) {
  if (st & 2) {
    const int rank = st >> 2;
    const int wi = rank >> 4;  // 16 codes a word
    const uint32_t word = (wi >= 0 && wi < tbw) ? __ldg(words + wi) : 0u;
    const uint32_t byte = (word >> (8 * ((rank >> 2) & 3))) & 0xFFu;
    const uint32_t code = (byte >> (6 - 2 * (rank & 3))) & 3u;
    return (0x74676361u >> (8 * code)) & 0xFFu;  // 'a', 'c', 'g', 't'
  }
  return (st & 1) ? 110u : 0u;  // 'n' in the read, 0 past it
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
tag_route_kernel(const uint32_t* __restrict__ words, long long tbw,
                 const int* __restrict__ state, uint8_t* __restrict__ out,
                 long long max_len) {
  const long long row = blockIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.y) * kCols + 4 * threadIdx.x;
  if (c0 >= max_len) return;
  const uint32_t* w = words + row * tbw;
  const int* st = state + row * max_len + c0;
  uint8_t* o = out + row * max_len + c0;
  if (kVec) {  // max_len % 4 == 0: the four columns are in the row
    const int4 s = __ldg(reinterpret_cast<const int4*>(st));
    *reinterpret_cast<uint32_t*>(o) = route(s.x, w, tbw) | (route(s.y, w, tbw) << 8) |
                                      (route(s.z, w, tbw) << 16) | (route(s.w, w, tbw) << 24);
  } else {
    const int n = max_len - c0 < 4 ? static_cast<int>(max_len - c0) : 4;
    for (int i = 0; i < n; ++i) o[i] = static_cast<uint8_t>(route(__ldg(st + i), w, tbw));
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes (ops/_build.py).  Launches on the
// given stream, never synchronises, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a width the grid does not take).  ``vec`` asks
// for the vector path: the caller has checked max_len % 4 == 0 and a 16-byte
// aligned state.

extern "C" int dxt_tag_route(const void* words, long long tbw, const void* state, void* out,
                             int n_rows, long long max_len, int vec, void* stream) {
  if (n_rows <= 0 || max_len <= 0) return 0;
  const long long col_blocks = (max_len + kCols - 1) / kCols;
  if (col_blocks > kMaxColBlocks || (vec && (max_len & 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(col_blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const int* st = static_cast<const int*>(state);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (vec)
    tag_route_kernel<true><<<grid, kThreads, 0, s>>>(w, tbw, st, o, max_len);
  else
    tag_route_kernel<false><<<grid, kThreads, 0, s>>>(w, tbw, st, o, max_len);
  return static_cast<int>(cudaGetLastError());
}
