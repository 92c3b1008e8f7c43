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
// bases, which follow it directly.
//
// Bound on the H100: by bytes, device memory: 1.25 bytes a base (one in, a
// quarter out), a table lookup and a few shifts each.
//
// K7 (pack2bit_kernel) owns tiles of the flat payload, not reads, so that
// every block has the same work whatever the reads' lengths: kPackTile
// bytes a block, 16 a thread, written as one 16-byte store (the payload
// comes from torch.empty, so every tile starts 16-byte aligned).  The block
// finds the reads that hold its first and last byte (tile_reads: one round
// of probes around each byte's read estimated from its position, with the
// offsets it needs loaded at once, and a k-ary search of all reads where
// the estimate misses).  The tile's bases are then one contiguous span of
// the flat input, which the block loads with aligned 16-byte loads
// (aligned down at the start, the last chunk past the span's end unused)
// and turns into 2-bit codes as they arrive, one table lookup a base, 16
// codes to a shared word, MSB-first.  Each thread finds the read of its
// first byte by a binary search between the tile's two reads (read_at) and
// takes four payload bytes of one read at a time with one funnel shift of
// two code words; near a read's end it goes byte by byte, masks the codes
// past the read and searches again where it crosses into a later read, so
// runs of empty reads cost a search, not a step each.  The code words keep
// a spare word after every 8, so that the lanes of a warp, whose windows
// lie 4 words apart, meet at most two to a bank.  The byte table's entries
// are read by a warp without conflict for the letters acgtACGT and 1234.
// Staging the raw bases instead and looking them up while packing (four
// lookups a payload byte) measured 1.2x slower (PERF.md).
//
// The unpack (unpack2bit_kernel) owns tiles of the flat letter output, one
// a warp: kUnpackWarpTile letters, 16 letters a group written as one 16-byte
// store (the letters come from torch.empty, so every group starts 16-byte
// aligned), kUnpackGroups groups a lane, 32 groups apart, so that each warp
// store writes 512 contiguous bytes.  The warp loads the letter and payload
// offsets of a window of 32 reads, a read a lane, around the read of its
// first letter estimated from its position; where the window holds the
// reads of the tile's first and last letters (reads of a few hundred
// letters and more), each group finds its read by a binary search of the
// lanes' offsets with shuffles, as many steps as the tile's reads need, and
// takes the next read's end and payload start from the window too; else
// the tile's two reads come from a k-ary search of all reads, 32 probes a
// round, and each group searches between them (read_at).  A group whose 16
// letters lie in one read, or in one read and the next, takes each read's
// codes from the aligned 32-bit payload word that holds their first byte
// and the next word, read only where it holds some of the read's codes
// (payloads start at any byte, and no byte past a read's is needed), joined
// by one funnel shift, MSB-first; bit-reversed, the codes become selector
// nibbles by three spreading steps, and four byte permutations of the
// letter table (its entries in the order that the reversal leaves each
// code's two bits) give the 16 letters.  Other groups (reads shorter than
// the group, the output's last letters) go letter by letter and search
// again where they cross into a later read, so a run of empty reads costs
// a search.  No shared memory and no barrier: each warp's chain is its
// offsets' load, a few shuffles, its payload words' load and its stores.
// Tiles of a block with the payload staged in shared memory (K7's schedule
// in reverse) measured slower than a block a read (PERF.md).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPackBytes = 16;                         // payload bytes a thread
constexpr int kPackTile = kPackBytes * kThreads;       // payload bytes a block: 4,096
constexpr int kPackMinBlocks = 6;                      // resident blocks an SM (40 registers)
constexpr int kSpanChunks = (4 * kPackTile + 15) / 16 + 1;   // 16-byte chunks of a tile's bases
constexpr int kChunksPerThread = (kSpanChunks + kThreads - 1) / kThreads;
constexpr int kCodeSlots = kSpanChunks + 2 + (kSpanChunks + 1) / 8;   // and a word past them, skewed
constexpr int kUnpackLetters = 16;                     // letters a group: one 16-byte store
constexpr int kUnpackGroups = 4;                       // groups a lane, 32 groups apart
constexpr int kUnpackWarpTile = kUnpackLetters * 32 * kUnpackGroups;   // letters a warp: 2,048
constexpr int kUnpackWarps = 8;                        // warps a block
constexpr int kUnpackTile = kUnpackWarpTile * kUnpackWarps;            // letters a block: 16,384

// Shared code word w of a staged span: a spare word after every 8.
__device__ __forceinline__ int skew(int w) { return w + (w >> 3); }

// ra and rb of tile_reads by a k-ary search with every thread of the block: a round
// probes kThreads evenly spaced entries of each range and keeps the stretch
// after the last probe that is <= its byte; ceil(log_256(n)) rounds.
__device__ void kary_reads(const int64_t* __restrict__ ends, int64_t n, int64_t ja, int64_t jb,
                           int64_t& ra, int64_t& rb) {
  int64_t lo_a = 0, hi_a = n, lo_b = 0, hi_b = n;
  while (hi_a - lo_a > 1 || hi_b - lo_b > 1) {
    const int64_t sa = (hi_a - lo_a + kThreads - 1) / kThreads;
    const int64_t sb = (hi_b - lo_b + kThreads - 1) / kThreads;
    const int64_t pa = lo_a + threadIdx.x * sa;
    const int64_t pb = lo_b + threadIdx.x * sb;
    // probe 0 is the range's start, <= its byte by the loop's invariant
    const int ca = __syncthreads_count(threadIdx.x == 0 || (pa < hi_a && ends[pa] <= ja));
    const int cb = __syncthreads_count(threadIdx.x == 0 || (pb < hi_b && ends[pb] <= jb));
    lo_a += (ca - 1) * sa;
    hi_a = lo_a + sa < hi_a ? lo_a + sa : hi_a;
    lo_b += (cb - 1) * sb;
    hi_b = lo_b + sb < hi_b ? lo_b + sb : hi_b;
  }
  ra = lo_a;
  rb = lo_b;
}

// The reads that hold bytes ja <= jb of a tile of a flat ragged output of
// n_out bytes, with every thread of the block: ends (n+1) from 0 bounds the
// reads' outputs (read i spans [ends[i], ends[i+1])), srcs (n+1) the reads'
// inputs in their flat buffer, jb < ends[n].  ra and rb are the largest
// reads with ends[r] <= ja and ends[r] <= jb, so never empty ones; the
// tile's input span is span_lo = lo_of(ends[ra], srcs[ra]) to span_hi =
// hi_of(ends[rb], srcs[rb], srcs[rb + 1]), the kernel's own rule.  A first
// round probes kThreads reads from an estimate of each byte's read (its
// share of n_out times n, less kThreads / 2), the probes loading srcs beside
// ends, and the threads that hold ra and rb compute the span; where a
// window does not hold its read (reads of uneven lengths), the k-ary
// search.
template <class Lo, class Hi>
__device__ __forceinline__ void tile_reads(const int64_t* __restrict__ ends,
                                           const int64_t* __restrict__ srcs, int64_t n,
                                           int64_t n_out, int64_t ja, int64_t jb, Lo lo_of,
                                           Hi hi_of, int64_t& ra, int64_t& rb, int64_t& span_lo,
                                           int64_t& span_hi) {
  __shared__ int64_t s_span[2];
  const int64_t top = n > kThreads ? n - kThreads : 0;
  auto window = [&](int64_t j) {
    const int64_t g = static_cast<int64_t>(static_cast<double>(j) / static_cast<double>(n_out) *
                                           static_cast<double>(n)) - kThreads / 2;
    return g < 0 ? 0 : (g > top ? top : g);
  };
  const int64_t ga = window(ja), gb = window(jb);
  const int64_t pa = ga + threadIdx.x, pb = gb + threadIdx.x;
  int64_t ea = 0, sa = 0, eb = 0, sb = 0, sb1 = 0;
  if (pa < n) { ea = ends[pa]; sa = srcs[pa]; }
  if (pb < n) { eb = ends[pb]; sb = srcs[pb]; sb1 = srcs[pb + 1]; }
  // the probes <= a byte are a prefix of its window; it holds the byte's read
  // where that prefix is not empty and ends inside the window or at read n
  const int ca = __syncthreads_count(pa < n && ea <= ja);
  const int cb = __syncthreads_count(pb < n && eb <= jb);
  if (ca >= 1 && (ca < kThreads || ga + kThreads >= n) &&
      cb >= 1 && (cb < kThreads || gb + kThreads >= n)) {
    if (threadIdx.x == ca - 1) s_span[0] = lo_of(ea, sa);
    if (threadIdx.x == cb - 1) s_span[1] = hi_of(eb, sb, sb1);
    __syncthreads();
    ra = ga + ca - 1;
    rb = gb + cb - 1;
    span_lo = s_span[0];
    span_hi = s_span[1];
    return;
  }
  kary_reads(ends, n, ja, jb, ra, rb);
  span_lo = lo_of(ends[ra], srcs[ra]);
  span_hi = hi_of(ends[rb], srcs[rb], srcs[rb + 1]);
}

// The read that holds byte j: the largest r in [lo, hi] with ends[r] <= j
// (ends[lo] <= j).
__device__ __forceinline__ int64_t read_at(const int64_t* __restrict__ ends, int64_t lo,
                                           int64_t hi, int64_t j) {
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (ends[mid] <= j) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, kPackMinBlocks)
pack2bit_kernel(const uint8_t* __restrict__ flat, const int64_t* __restrict__ offs,
                const int64_t* __restrict__ out_offs, const uint8_t* __restrict__ lut,
                uint8_t* __restrict__ out, int64_t n_reads, int64_t n_out) {
  __shared__ uint8_t s_tab[256];
  __shared__ uint32_t s_code[kCodeSlots];   // code of staged base p: word p >> 4, bits 31 - 2(p & 15)
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kPackTile;
  const int64_t j1 = j0 + kPackTile < n_out ? j0 + kPackTile : n_out;
  for (int i = threadIdx.x; i < 256; i += kThreads) s_tab[i] = lut[i] & 3u;
  // the tile's bases, flat[in_lo, in_hi), staged from in_lo aligned down;
  // tile_reads' barriers also publish the table
  int64_t ra, rb, in_lo, in_hi;
  tile_reads(
      out_offs, offs, n_reads, n_out, j0, j1 - 1,
      [j0](int64_t end, int64_t src) { return src + 4 * (j0 - end); },
      [j1](int64_t end, int64_t src, int64_t src1) {
        const int64_t hi = src + 4 * (j1 - end);
        return hi < src1 ? hi : src1;
      },
      ra, rb, in_lo, in_hi);
  const int64_t origin = in_lo - static_cast<int64_t>(reinterpret_cast<uintptr_t>(flat + in_lo) & 15);
  const int n_chunks = static_cast<int>((in_hi - origin + 15) >> 4);
  const uint4* src = reinterpret_cast<const uint4*>(flat + origin);
  uint4 v[kChunksPerThread];
#pragma unroll
  for (int k = 0; k < kChunksPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < n_chunks) v[k] = src[c];
  }
#pragma unroll
  for (int k = 0; k < kChunksPerThread; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c < n_chunks) {
      const uint32_t q[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      uint32_t acc = 0;
#pragma unroll
      for (int b = 0; b < 16; ++b) acc = acc * 4 + s_tab[(q[b >> 2] >> (8 * (b & 3))) & 255];
      s_code[skew(c)] = acc;
    }
  }
  __syncthreads();
  const int jt = kPackBytes * threadIdx.x;   // the thread's first byte in the tile
  if (j0 + jt >= j1) return;
  const int nb = j1 - j0 - jt < kPackBytes ? static_cast<int>(j1 - j0 - jt) : kPackBytes;
  const int span_end = static_cast<int>(in_hi - origin);
  // read r, in staged bases: x0 the first base of its (maybe virtual) byte
  // j0, lim its end (at most the span's); e its end in the tile's bytes
  int x0, lim, e;
  auto bounds = [&](int64_t r) {
    const int64_t o = out_offs[r], o1 = out_offs[r + 1], b1 = offs[r + 1] - origin;
    x0 = static_cast<int>(offs[r] - origin - 4 * (o - j0));
    lim = b1 < span_end ? static_cast<int>(b1) : span_end;
    e = static_cast<int>((o1 < j1 ? o1 : j1) - j0);
  };
  int64_t r = read_at(out_offs, ra, rb, j0 + jt);
  bounds(r);
  int x = x0 + 4 * jt;
  // the 16 codes from staged base p on, MSB-first: four payload bytes
  auto codes16 = [&](int p) {
    const int c = p >> 4;
    return __funnelshift_l(s_code[skew(c + 1)], s_code[skew(c)], 2 * (p & 15));
  };
  uint32_t w[kPackBytes / 4];
#pragma unroll
  for (int g = 0; g < kPackBytes / 4; ++g) {
    if (4 * g + 4 <= nb && x + 16 <= lim) {   // four bytes of one read
      w[g] = __byte_perm(codes16(x), 0u, 0x0123);
      x += 16;
    } else {
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * g + k;
        if (i < nb) {
          if (jt + i >= e) {   // the next read that is not empty
            r = read_at(out_offs, r + 1, rb, j0 + jt + i);
            bounds(r);
            x = x0 + 4 * (jt + i);
          }
          uint32_t b = codes16(x) >> 24;
          const int left = lim - x;   // bases of the read from x on, >= 1
          // codes at or past the read's length are 0 (DB.c:329-331)
          if (left < 4) b &= (0xff00u >> (2 * left)) & 0xffu;
          acc |= b << (8 * k);
          x += 4;
        }
      }
      w[g] = acc;
    }
  }
  uint8_t* dst = out + j0 + jt;
  if (nb == kPackBytes) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; i < nb; ++i) dst[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
  }
}

// 16 codes of a read from its code q on, the first in bits 31-30, of which
// the first k (1-16) are the read's: from the aligned word that holds code
// q's byte and the next word, read only when it holds some of those k (so
// no byte past the read's is read where the next word would be needed).
__device__ __forceinline__ uint32_t read_codes(const uint8_t* __restrict__ payload,
                                               int64_t src, int q, int k) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(payload + src + (q >> 2));
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(at & ~uintptr_t{3});
  const int sh = 8 * static_cast<int>(at & 3) + 2 * (q & 3);
  const uint32_t hi = __byte_perm(wp[0], 0u, 0x0123);
  const uint32_t lo = sh + 2 * k > 32 ? __byte_perm(wp[1], 0u, 0x0123) : 0u;
  return __funnelshift_l(lo, hi, sh);
}

__global__ void __launch_bounds__(32 * kUnpackWarps)
unpack2bit_kernel(const uint8_t* __restrict__ payload, const int64_t* __restrict__ pay_offs,
                  const int64_t* __restrict__ out_offs, const uint8_t* __restrict__ letter_lut,
                  uint8_t* __restrict__ out, int64_t n_reads, int64_t n_out) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kUnpackWarps + (threadIdx.x >> 5)) *
                     kUnpackWarpTile;
  if (j0 >= n_out) return;
  const int64_t j1 = j0 + kUnpackWarpTile < n_out ? j0 + kUnpackWarpTile : n_out;
  const uint32_t lut = letter_lut[0] | (letter_lut[1] << 8) | (letter_lut[2] << 16) |
                       (static_cast<uint32_t>(letter_lut[3]) << 24);
  // the table by a code with its two bits swapped, the order __brev leaves them in
  const uint32_t lut_sw = __byte_perm(lut, 0u, 0x3120);
  // a window of 32 reads around the tile's first letter's read estimated from
  // its position, a read a lane: its first letter relative to j0 (clamped to
  // int32; reads past the last start at n_out, past every letter) and its
  // payload's start
  const int64_t top = n_reads > 32 ? n_reads - 32 : 0;
  auto clamp = [top](int64_t g) { return g < 0 ? 0 : (g > top ? top : g); };
  auto rel = [j0](int64_t o) {
    const int64_t d = o - j0;
    return static_cast<int>(d < INT32_MIN ? INT32_MIN : (d > INT32_MAX ? INT32_MAX : d));
  };
  const int jt1 = static_cast<int>(j1 - j0);
  int64_t g = clamp(static_cast<int64_t>(static_cast<double>(j0) / static_cast<double>(n_out) *
                                         static_cast<double>(n_reads)) - 16);
  int e, e_next, na, nb;
  int64_t p;
  bool win;
  for (int attempt = 0;; ++attempt) {
    const int64_t pr = g + lane < n_reads ? g + lane : n_reads;
    const int64_t e64 = out_offs[pr];
    e = rel(e64);
    p = pay_offs[pr];
    e_next = rel(out_offs[g + 32 < n_reads ? g + 32 : n_reads]);
    na = __popc(__ballot_sync(kAll, e <= 0));
    nb = __popc(__ballot_sync(kAll, e <= jt1 - 1));
    // the window holds the reads of the tile's first and last letters
    win = na >= 1 && (nb < 32 || e_next > jt1 - 1);
    if (win || attempt) break;
    // a second window where this one puts the first letter's read: before
    // it or after it by interpolation, else from that read on
    const int64_t e0 = __shfl_sync(kAll, e64, 0), e31 = __shfl_sync(kAll, e64, 31);
    if (na == 0) {
      g = clamp(static_cast<int64_t>(static_cast<double>(j0) / static_cast<double>(e0) *
                                     static_cast<double>(g)) - 16);
    } else if (na < 32) {
      g = clamp(g + na - 1);
    } else {
      g = clamp(g + 31 + static_cast<int64_t>(static_cast<double>(j0 - e31) /
                                              static_cast<double>(n_out - e31) *
                                              static_cast<double>(n_reads - g - 31)) - 16);
    }
  }
  int64_t ra = g + na - 1, rb = g + nb - 1;
  if (!win) {   // a k-ary search of all reads, 32 probes a round for each letter
    int64_t lo_a = 0, hi_a = n_reads, lo_b = 0, hi_b = n_reads;
    while (hi_a - lo_a > 1 || hi_b - lo_b > 1) {
      const int64_t sa = (hi_a - lo_a + 31) / 32, sb = (hi_b - lo_b + 31) / 32;
      const int64_t qa = lo_a + lane * sa, qb = lo_b + lane * sb;
      const int ca = __popc(__ballot_sync(kAll, lane == 0 || (qa < hi_a && out_offs[qa] <= j0)));
      const int cb = __popc(__ballot_sync(kAll, lane == 0 || (qb < hi_b && out_offs[qb] <= j1 - 1)));
      lo_a += (ca - 1) * sa;
      hi_a = lo_a + sa < hi_a ? lo_a + sa : hi_a;
      lo_b += (cb - 1) * sb;
      hi_b = lo_b + sb < hi_b ? lo_b + sb : hi_b;
    }
    ra = lo_a;
    rb = lo_b;
  }
  // binary search steps over the window's reads of the tile
  const int steps = nb - na > 0 ? 32 - __clz(nb - na) : 0;
#pragma unroll
  for (int gi = 0; gi < kUnpackGroups; ++gi) {
    const int jt = kUnpackLetters * (lane + 32 * gi);   // the group's first letter, from j0
    const int jq = jt < jt1 ? jt : jt1 - 1;
    // read r of letter jq, its letters [o, o1) and payload from src; in the
    // window also the next read's end o2 and payload src1
    int64_t r, src, src1 = 0;
    int o, o1, o2 = 0;
    if (win) {   // by a binary search of the lanes' reads, every lane taking part
      int lo = na - 1, hi = nb - 1;
      for (int s = 0; s < steps; ++s) {
        const int mid = (lo + hi + 1) >> 1;
        if (__shfl_sync(kAll, e, mid) <= jq) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      r = g + lo;
      o = __shfl_sync(kAll, e, lo);
      src = __shfl_sync(kAll, p, lo);
      const int n1 = __shfl_sync(kAll, e, lo < 31 ? lo + 1 : 31);
      const int n2 = __shfl_sync(kAll, e, lo < 30 ? lo + 2 : 31);
      src1 = __shfl_sync(kAll, p, lo < 31 ? lo + 1 : 31);
      o1 = lo < 31 ? n1 : e_next;
      o2 = lo < 30 ? n2 : (lo == 30 ? e_next : o1);   // o2 == o1: not known
    } else {
      r = read_at(out_offs, ra, rb, j0 + jq);
      o = rel(out_offs[r]);
      o1 = rel(out_offs[r + 1]);
      src = pay_offs[r];
    }
    if (jt >= jt1) continue;
    const int nl = jt1 - jt < kUnpackLetters ? jt1 - jt : kUnpackLetters;
    uint32_t w[4];
    const int na16 = o1 - jt;   // the group's letters in read r
    if (nl == kUnpackLetters && (na16 >= kUnpackLetters || o2 - jt >= kUnpackLetters)) {
      // the 16 letters lie in read r, or in read r and the next
      const int ka = na16 < kUnpackLetters ? na16 : kUnpackLetters;
      uint32_t c = read_codes(payload, src, jt - o, ka);
      if (ka < kUnpackLetters) {
        const uint32_t keep = 0xffffffffu >> (2 * ka);
        c = (c & ~keep) | (read_codes(payload, src1, 0, kUnpackLetters - ka) >> (2 * ka));
      }
      // the codes, the first in bits 1-0 (its bits swapped), to selector
      // nibbles: codes 0-7 in lo, 8-15 in hi
      const uint32_t c16 = __brev(c);
      uint32_t lo = c16 & 0xffffu, hi = c16 >> 16;
      lo = (lo | (lo << 8)) & 0x00ff00ffu;
      hi = (hi | (hi << 8)) & 0x00ff00ffu;
      lo = (lo | (lo << 4)) & 0x0f0f0f0fu;
      hi = (hi | (hi << 4)) & 0x0f0f0f0fu;
      lo = (lo | (lo << 2)) & 0x33333333u;
      hi = (hi | (hi << 2)) & 0x33333333u;
      w[0] = __byte_perm(lut_sw, 0u, lo);
      w[1] = __byte_perm(lut_sw, 0u, lo >> 16);
      w[2] = __byte_perm(lut_sw, 0u, hi);
      w[3] = __byte_perm(lut_sw, 0u, hi >> 16);
    } else {   // letter by letter, into the next read that is not empty at a read's end
      w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
      for (int i = 0; i < kUnpackLetters; ++i) {
        if (i < nl) {
          const int jl = jt + i;
          if (jl >= o1) {
            r = read_at(out_offs, r + 1, rb, j0 + jl);
            o = rel(out_offs[r]);
            o1 = rel(out_offs[r + 1]);
            src = pay_offs[r];
          }
          const int q = jl - o;
          const uint32_t code = (payload[src + (q >> 2)] >> (6 - 2 * (q & 3))) & 3u;
          w[i >> 2] |= ((lut >> (8 * code)) & 0xffu) << (8 * (i & 3));
        }
      }
    }
    uint8_t* dst = out + j0 + jt;
    if (nl == kUnpackLetters) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int i = 0; i < nl; ++i) dst[i] = static_cast<uint8_t>(w[i >> 2] >> (8 * (i & 3)));
    }
  }
}

}  // namespace

// flat: the reads' ascii bases; offs (n_reads + 1) int64: read i is
// flat[offs[i], offs[i+1]); out_offs (n_reads + 1) int64: the exclusive
// cumsum of ceil(len/4) from 0, where read i's payload goes; lut (256) u8
// codes 0-3; out: n_out = out_offs[n_reads] bytes, 16-byte aligned.
extern "C" int dxt_pack2bit(const void* flat, const void* offs, const void* out_offs,
                            const void* lut, void* out, long long n_reads, long long n_out,
                            void* stream) {
  if (n_reads <= 0 || n_out <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_out + kPackTile - 1) / kPackTile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pack2bit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(flat), static_cast<const int64_t*>(offs),
      static_cast<const int64_t*>(out_offs), static_cast<const uint8_t*>(lut),
      static_cast<uint8_t*>(out), n_reads, n_out);
  return static_cast<int>(cudaGetLastError());
}

// payload: the reads' packed bytes, end to end; pay_offs (n_reads + 1)
// int64: read i's ceil(len/4) bytes start at pay_offs[i]; out_offs (n_reads
// + 1) int64 from 0: read i's len letters go to out[out_offs[i],
// out_offs[i+1]); letter_lut (4) u8; out: n_out = out_offs[n_reads] bytes,
// 16-byte aligned.
extern "C" int dxt_unpack2bit(const void* payload, const void* pay_offs, const void* out_offs,
                              const void* letter_lut, void* out, long long n_reads,
                              long long n_out, void* stream) {
  if (n_reads <= 0 || n_out <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_out + kUnpackTile - 1) / kUnpackTile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  unpack2bit_kernel<<<static_cast<unsigned>(tiles), 32 * kUnpackWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int64_t*>(pay_offs),
      static_cast<const int64_t*>(out_offs), static_cast<const uint8_t*>(letter_lut),
      static_cast<uint8_t*>(out), n_reads, n_out);
  return static_cast<int>(cudaGetLastError());
}
