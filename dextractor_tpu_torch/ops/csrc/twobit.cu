// Hand-written Hopper kernels (sm_90a) of the 2-bit codecs (.dexta, .dexar).
//
//   dxt_pack2bit    K7, replaces dextractor_tpu/ops/emit_pallas.py::pack2bit_pallas
//   dxt_unpack2bit  the decode's unpack; the JAX package has no Pallas kernel
//                   for it (twobit.unpack_translate, XLA arithmetic)
//
// dxt_pack2bit computes Number_Read + Compress_Read (DB.c:319-338): every
// ascii base through a 256-entry table to a 2-bit code, codes at or past the
// read's length zero, four codes a byte with the first in bits 7-6.  One
// table serves every alphabet: the JAX package's arithmetic pack_translate
// (acgt, arrow) equals the table on all 256 byte values.  dxt_unpack2bit is
// the mirror (Uncompress_Read + Lower/Upper_Read, DB.c:342-416): code c of a
// read becomes letters[c], exactly len letters per read.  The plain PyTorch
// twins (ops/twobit.py: pack2bit_twin, unpack2bit_twin) compute the same
// functions; chip_smoke.py holds each kernel against its twin bit for bit.
//
// Both work on the flat ragged buffers of the container, not on a padded
// rectangle: the reads' bases end to end with int64 offsets (N+1), and
// their payloads end to end, read i's at out_offs[i], ceil(len/4) bytes,
// offsets the host knows before the launch.  So no pad and no compaction
// runs on either side, and a read's tail masks against the next read's
// bases, which follow it directly.  One block owns one read and walks its
// payload bytes with a block-stride loop, one byte a thread a step: the
// thread reads the byte's four bases (or writes its up to four letters).
// A read of length 0 has no payload and its block does nothing; the
// wrapper launches no grid for a batch without payload.
//
// Bound on the H100: by bytes, device memory: 1.25 bytes a base (one in, a
// quarter out), a table lookup and a few shifts each.  The table sits in
// shared memory (the letters of the unpack in a register).  Loads and
// stores are single bytes; neighbouring threads touch neighbouring bytes,
// so a warp's accesses fall into a few 128-byte lines.  Vector loads (16
// bytes a thread) would need aligned starts that ragged reads do not have.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // also the table's size: one entry a thread

__global__ void __launch_bounds__(kThreads)
pack2bit_kernel(const uint8_t* __restrict__ flat, const int64_t* __restrict__ offs,
                const int64_t* __restrict__ out_offs, const uint8_t* __restrict__ lut,
                uint8_t* __restrict__ out) {
  __shared__ uint8_t s_lut[256];
  s_lut[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const int64_t r = blockIdx.x;
  const int64_t in0 = offs[r];
  const int64_t len = offs[r + 1] - in0;
  const int64_t nbytes = (len + 3) >> 2;
  const uint8_t* src = flat + in0;
  uint8_t* dst = out + out_offs[r];
  for (int64_t j = threadIdx.x; j < nbytes; j += kThreads) {
    const int64_t p = 4 * j;
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // codes at or past the read's length are 0 (DB.c:329-331): the bytes
      // there are the next read's bases and are never read
      if (p + k < len) b |= static_cast<uint32_t>(s_lut[src[p + k]]) << (6 - 2 * k);
    }
    dst[j] = static_cast<uint8_t>(b);
  }
}

__global__ void __launch_bounds__(kThreads)
unpack2bit_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ pay_offs,
                  const int64_t* __restrict__ out_offs, const uint8_t* __restrict__ letter_lut,
                  uint8_t* __restrict__ out) {
  const uint32_t letters = letter_lut[0] | (letter_lut[1] << 8) | (letter_lut[2] << 16) |
                           (static_cast<uint32_t>(letter_lut[3]) << 24);
  const int64_t r = blockIdx.x;
  const int64_t o0 = out_offs[r];
  const int64_t len = out_offs[r + 1] - o0;
  const int64_t nbytes = (len + 3) >> 2;
  const uint8_t* src = payload + pay_offs[r];
  uint8_t* dst = out + o0;
  for (int64_t j = threadIdx.x; j < nbytes; j += kThreads) {
    const uint32_t b = src[j];
    const int64_t p = 4 * j;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (p + k < len) {
        const uint32_t code = (b >> (6 - 2 * k)) & 3u;
        dst[p + k] = static_cast<uint8_t>(letters >> (8 * code));
      }
    }
  }
}

}  // namespace

// flat: the reads' ascii bases; offs (n_reads + 1) int64: read i is
// flat[offs[i], offs[i+1]); out_offs (n_reads + 1) int64: the exclusive
// cumsum of ceil(len/4), where read i's payload goes; lut (256) u8.
extern "C" int dxt_pack2bit(const void* flat, const void* offs, const void* out_offs,
                            const void* lut, void* out, long long n_reads, void* stream) {
  if (n_reads <= 0) return 0;
  pack2bit_kernel<<<static_cast<unsigned>(n_reads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(out_offs), static_cast<const uint8_t*>(lut),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// payload: the reads' packed bytes; pay_offs (n_reads + 1) int64: read i's
// payload starts at pay_offs[i]; out_offs (n_reads + 1) int64: read i's
// len letters go to out[out_offs[i], out_offs[i+1]); letter_lut (4) u8.
extern "C" int dxt_unpack2bit(const void* payload, const void* pay_offs, const void* out_offs,
                              const void* letter_lut, void* out, long long n_reads,
                              void* stream) {
  if (n_reads <= 0) return 0;
  unpack2bit_kernel<<<static_cast<unsigned>(n_reads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(pay_offs),
      static_cast<const int64_t*>(out_offs), static_cast<const uint8_t*>(letter_lut),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
