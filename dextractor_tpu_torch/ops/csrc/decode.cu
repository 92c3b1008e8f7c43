// Hand-written Hopper kernels (sm_90a) of the .dexqv decode path.
//
//   dxt_decode_plain  K4a + K4b, replaces dextractor_tpu/ops/decode_conveyor.py::
//                     plain_chains_conveyor (C channels in one launch) and
//                     ::plain_chain_conveyor (one channel: the same kernel, C = 1)
//   dxt_decode_run    K5, replaces dextractor_tpu/ops/decode_conveyor.py::run_chain_conveyor
//   dxt_expand_runs   K6, replaces dextractor_tpu/ops/expand_pallas.py::expand_runs_pallas,
//                     and with tag bytes the XLA shift network of decode2.expand_del_tag
//
// What they compute is the JAX package's XLA formulation (decode2.plain_chain,
// run_chain, expand_runs2, expand_del_tag), the reference's Decode and
// Decode_Run (QV.c:510-691); the plain PyTorch twins in ops/decode2.py compute
// the same functions, and chip_smoke.py holds each kernel against its twin bit
// for bit.  None of the TPU machinery carries over: no VMEM conveyor, no
// interleaved tiles, no advance or shift networks.
//
// Bound on the H100.  A Huffman chain is serial: the position of symbol j+1 is
// known only after symbol j is looked up.  A chain walked by one thread is
// bound by the latency of one chain step (a table lookup in shared memory, a
// few integer operations) times the chain's symbols, not by bytes: a
// 2,000-symbol row is ~1 KB of words in and 2 KB out.  So K4 and K5 decode a
// chain with a whole warp whose lanes speculate on slices of its bits and
// synchronise by shuffles (decode_plain_kernel, decode_run_kernel): a chain
// costs a few passes of one slice's steps per window of 32 slices, not its
// symbols' steps, and a batch fills the card with warps instead of threads.
// K4 takes the C plain channels of one launch as blockIdx.y, each with its
// own rectangle width, stages each window's words in shared memory, and
// writes every column of its rows (the decoded symbols, then zeros), 16
// bytes a store where aligned; K5 writes padding tokens past each chain's
// end.  The L1 tables and, when it fits in 32 KB, the L2 table sit in
// shared memory.  K6 is bound by bytes (it writes every
// column of its rows once): a warp a row (8 warps a row for few rows or
// rows of more tokens, 32 for the widest), each warp a slice of the row's
// tokens, whose columns it
// builds in shared memory (rchar and -1, then literal k at column
// cumsum(runs)[k] + k and its delTag letter beside it) and writes once, 16
// bytes a store; runs are >= 0, so each slice owns one span of columns
// (expand_runs_kernel).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr long long kSmemL2Max = 8192;  // L2 entries staged in shared memory (32 KB);
                                        // decode_chains.SMEM_L2_MAX mirrors it
constexpr long long kColCap = 1LL << 30;  // K6: the most columns and tokens a row

struct PlainChannels {
  const uint32_t* rect[kMaxChannels];  // (N, k) words of each channel
  long long k[kMaxChannels];
  int signal[kMaxChannels];            // escape symbol: 255 (type 2) or 256 (never)
  int subw[kMaxChannels];              // L2 row width, 0: the channel reads L1 only
};

// A chain's 64-bit window over its row of words; reads past the row repeat
// its last word (decode2.py:228).  The two words stay in registers, and a
// word is loaded only when the position moves into it.
struct Window {
  const uint32_t* row;
  long long k;
  long long cur;
  uint32_t hi, lo;

  __device__ __forceinline__ uint32_t word(long long i) const {
    return __ldg(row + (i < 0 ? 0 : (i < k ? i : k - 1)));
  }
  __device__ __forceinline__ uint64_t at(long long pos) {
    const long long w = pos >> 5;
    if (w != cur) {
      hi = w == cur + 1 ? lo : word(w);
      lo = word(w + 1);
      cur = w;
    }
    return (static_cast<uint64_t>(hi) << 32) | lo;
  }
};

// Bits [off, off + n) of the window, n <= 16 and off + n <= 64.
__device__ __forceinline__ int bits_at(uint64_t w, int off, int n) {
  return static_cast<int>((w >> (64 - n - off)) & ((1u << n) - 1u));
}

// len << 9 | sym of the 16 window bits cw via the two-level tables; an L2
// index past the table reads 0 (decode2._entry_lookup).
__device__ __forceinline__ int lookup(const int* l1, const int* l2, long long l2_len,
                                      int subw, int lmax, int cw) {
  int e = l1[cw >> 8];
  if (subw && ((e >> 20) & 1)) {
    const long long i2 = static_cast<long long>(e & 0xFFFF) * subw +
                         ((cw >> (16 - lmax)) & (subw - 1));
    e = i2 < l2_len ? l2[i2] : 0;
  }
  return e;
}

__device__ __forceinline__ void stage_l2(int* s_l2, const int* f2, long long f2_len) {
  for (long long i = threadIdx.x; i < f2_len; i += blockDim.x) s_l2[i] = f2[i];
}

// K4: one warp per (channel, chain).  K5's schedule (below) with one phase:
// the chain's bits are walked in windows of 32 lanes x kPlainLaneBits bits,
// and lane i owns the bits [w0 + i * kPlainLaneBits, w0 + (i + 1) *
// kPlainLaneBits) of the window that starts at the chain's position w0.
//  1. Stage: the warp copies the window's words (kPlainWinWords of them, the
//     last word of the row repeated past it) into shared memory, so every
//     read of the passes below is a shared load.
//  2. Speculate: lane 0 starts at the chain's true position, every other
//     lane at its first bit, and each decodes until it passes its end.  A
//     0-bit code that is no escape stalls a lane: its position no longer
//     moves, so the serial chain repeats that symbol to its end.
//  3. Synchronise: each lane takes its left neighbour's exit position as its
//     start and decodes again, until no start changes up to the first
//     stalled lane (the lanes past it lie past the chain's end).  A code
//     that never resynchronises (every code 8 bits long, a lane started
//     inside one) settles lane by lane in at most 32 rounds.
//  4. Scan: a warp scan of the lanes' symbol counts (a stalled lane counts
//     kStallSyms more) gives each lane the index of its first symbol.
//  5. Write: each lane decodes again from its settled start and writes its
//     symbols (a plain code is one symbol, an escape a code and an 8-bit
//     literal) while its index is below len; the lane that reaches len (or
//     stalls) gives the chain's bits and last.  Junk read past the row never
//     lands, since no lane writes past len.  A lane stores its symbols
//     straight to the row, four to a 32-bit store where it holds the word
//     whole (faster on the H100 than staging a window's symbols in shared
//     memory and storing them 16 bytes at a time, PERF.md).
// The next window starts at the last lane's exit.  Then the warp fills the
// stalled symbol up to len, and zeros from len to max_len, with 16-byte
// stores where aligned.  The L1 tables, and the L2 table up to kSmemL2Max
// entries, sit in shared memory, staged once a block; the C channels of a
// launch are blockIdx.y, each with its own rectangle width.
constexpr int kPlainWarps = 8;                          // chains per block
constexpr int kPlainLaneBits = 128;                     // bits a lane owns in a window
constexpr int kPlainWinWords = kPlainLaneBits + 2;      // words a window reads
constexpr long long kStallSyms = 1LL << 40;             // a stalled lane's symbols
constexpr unsigned kAll = 0xffffffffu;

// One lane's reader of its warp's staged window words, with the two words
// under its position kept in registers.
struct PlainReader {
  const uint32_t* sw;
  const int* l1;
  const int* l2;
  long long l2_len;
  int subw, lmax, signal;
  int cur;
  uint32_t hi, lo;

  __device__ __forceinline__ uint64_t at(int q) {
    const int i = q >> 5;
    if (i != cur) {
      hi = i == cur + 1 ? lo : sw[i];
      lo = sw[i + 1];
      cur = i;
    }
    return (static_cast<uint64_t>(hi) << 32) | lo;
  }

  // One code at window bit q: its symbol, q past it, and its width (8 after
  // an escape; 0 for a 0-bit code, which leaves q where it was).
  __device__ __forceinline__ int step(int& q, int& width) {
    const uint64_t w = at(q);
    const int p = q & 31;
    const int e = lookup(l1, l2, l2_len, subw, lmax, bits_at(w, p, 16));
    const int nb = (e >> 9) & 31;
    const int sym = e & 511;
    if (sym == signal) {
      q += nb + 8;
      width = 8;
      return bits_at(w, p + nb, 8);
    }
    q += nb;
    width = nb;
    return sym;
  }
};

// out[from, to) = v by the 32 lanes of a warp: 16-byte stores where the
// address allows, single bytes at the two ends.
__device__ __forceinline__ void warp_fill(uint8_t* out, long long from, long long to,
                                          uint8_t v, int lane) {
  if (from >= to) return;
  const long long mis = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(out + from) & 15)) & 15;
  const long long body = from + (mis < to - from ? mis : to - from);
  const long long end = body + ((to - body) & ~15LL);
  if (lane < body - from) out[from + lane] = v;
  const uint32_t v4 = v * 0x01010101u;
  const uint4 v16 = make_uint4(v4, v4, v4, v4);
  for (long long i = body + 16LL * lane; i < end; i += 16 * 32) {
    *reinterpret_cast<uint4*>(out + i) = v16;
  }
  if (lane < to - end) out[end + lane] = v;
}

// A lane's symbol stores straight to the row: four symbols of a word it
// holds whole go as one 32-bit store (rows of a width that is a multiple of
// 4), the others as single bytes.
struct DirectSink {
  uint8_t* out;
  long long first;  // the lane's first symbol index
  bool words;
  uint32_t acc;

  __device__ __forceinline__ void put(long long j, int sym) {
    if (!words || (j & ~3LL) < first) {
      out[j] = static_cast<uint8_t>(sym);
      return;
    }
    acc |= static_cast<uint32_t>(sym & 0xFF) << (8 * (j & 3));
    if ((j & 3) == 3) {
      *reinterpret_cast<uint32_t*>(out + j - 3) = acc;
      acc = 0u;
    }
  }
  // end: the index after the lane's last symbol
  __device__ __forceinline__ void flush(long long end) {
    if (words && (end & 3) && (end & ~3LL) >= first) {
      for (int b = 0; b < (end & 3); ++b) out[(end & ~3LL) + b] = static_cast<uint8_t>(acc >> (8 * b));
    }
  }
};

__global__ void __launch_bounds__(32 * kPlainWarps)
decode_plain_kernel(PlainChannels ch, const int* __restrict__ rlens,
                    const int* __restrict__ pos0, const int* __restrict__ f1,
                    const int* __restrict__ f2, long long f2_len, int lmax, bool l2_smem,
                    uint8_t* __restrict__ syms, int* __restrict__ bits_out,
                    int* __restrict__ last_out, int n_rows, long long max_len) {
  extern __shared__ int s_l2[];
  __shared__ int s_l1[256];
  __shared__ uint32_t s_win[kPlainWarps][kPlainWinWords];
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_l1[i] = f1[c * 256 + i];
  if (l2_smem) stage_l2(s_l2, f2, f2_len);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPlainWarps + warp;
  if (row >= n_rows) return;

  const long long r = static_cast<long long>(c) * n_rows + row;
  const long long k = ch.k[c];
  const uint32_t* src = ch.rect[c] + row * k;
  uint32_t* sw = s_win[warp];
  PlainReader rd{sw, s_l1, l2_smem ? s_l2 : f2, f2_len, ch.subw[c], lmax, ch.signal[c], -2,
                 0u, 0u};
  const long long rl = rlens[row];
  const long long len = rl < 0 ? 0 : (rl < max_len ? rl : max_len);
  uint8_t* out = syms + r * max_len;
  const bool words = (max_len & 3) == 0;
  long long pos = pos0 ? pos0[r] : 0;  // the chain's position between windows
  long long em = 0;                    // symbols before the window
  long long end_pos = pos, fill_from = -1;
  int end_last = 0, fill_sym = 0;
  bool done = len <= 0;

  while (!done) {
    const long long base = pos >> 5;
    __syncwarp();
    for (int i = lane; i < kPlainWinWords; i += 32) {
      const long long wi = base + i;
      sw[i] = __ldg(src + (wi < 0 ? 0 : (wi < k ? wi : k - 1)));
    }
    __syncwarp();
    rd.cur = -2;
    const int q0 = static_cast<int>(pos & 31);
    const int lane_end = q0 + (lane + 1) * kPlainLaneBits;
    int start = q0 + lane * kPlainLaneBits;
    int xq, n_sym;
    bool stalled;
    for (;;) {  // speculate, then synchronise until no start changes
      xq = start;
      n_sym = 0;
      stalled = false;
      while (xq < lane_end) {
        int q = xq, width;
        rd.step(q, width);
        if (width == 0) {
          stalled = true;
          break;
        }
        xq = q;
        ++n_sym;
      }
      int nstart = __shfl_up_sync(kAll, xq, 1);
      if (lane == 0) nstart = start;
      const unsigned stalls = __ballot_sync(kAll, stalled);
      const int first_stall = stalls ? __ffs(stalls) - 1 : 31;
      const bool moved = nstart != start && lane <= first_stall;
      start = nstart;
      if (!__any_sync(kAll, moved)) break;
    }
    // exclusive scan of the lanes' symbols
    const long long cnt = n_sym + (stalled ? kStallSyms : 0);
    long long inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long t = __shfl_up_sync(kAll, inc, d);
      if (lane >= d) inc += t;
    }
    long long ec = em + inc - cnt;
    // the write pass
    bool ends = false;
    long long fpos = 0, sfrom = -1;
    int flast = 0, ssym = 0;
    {
      DirectSink sink{out, ec, words, 0u};
      int q = start;
      while (ec < len && q < lane_end) {
        int q2 = q, width;
        const int sym = rd.step(q2, width);
        if (width == 0) {  // the rest of the chain repeats sym
          ends = true;
          fpos = (base << 5) + q;
          sfrom = ec;
          ssym = sym;
          break;
        }
        sink.put(ec, sym);
        ++ec;
        q = q2;
        if (ec == len) {
          ends = true;
          fpos = (base << 5) + q;
          flast = width;
          break;
        }
      }
      sink.flush(ec);
    }
    const unsigned enders = __ballot_sync(kAll, ends);
    if (enders) {
      const int src_lane = __ffs(enders) - 1;
      end_pos = __shfl_sync(kAll, fpos, src_lane);
      end_last = __shfl_sync(kAll, flast, src_lane);
      fill_from = __shfl_sync(kAll, sfrom, src_lane);
      fill_sym = __shfl_sync(kAll, ssym, src_lane);
      done = true;
    } else {
      pos = (base << 5) + __shfl_sync(kAll, xq, 31);
      em += __shfl_sync(kAll, inc, 31);
    }
  }
  __syncwarp();
  if (fill_from >= 0) warp_fill(out, fill_from, len, static_cast<uint8_t>(fill_sym), lane);
  warp_fill(out, len, max_len, 0, lane);
  if (lane == 0) {
    bits_out[r] = static_cast<int>(end_pos);
    last_out[r] = end_last;
  }
}

// K5: one warp per run chain.  The chain's bits are walked in windows of
// 32 lanes x kLaneBits bits (the GPU Huffman decode of "Revisiting Huffman
// Coding", arXiv 2010.10039, and arXiv 2201.09118).  In a window, lane i
// owns the bits [w0 + i * kLaneBits, w0 + (i + 1) * kLaneBits) and decodes
// codes from its start until it passes its end (or kLaneCodes codes: a
// 0-bit code cannot hold it forever).  A state is (bit position, phase):
// phase 0 reads a run code, phase 1 a literal code.
//  1. Speculate: lane 0 starts at the chain's true state, every other lane
//     at its first bit in the run phase.
//  2. Synchronise: each lane takes its left neighbour's exit state as its
//     start and decodes again, until no start changes (a Huffman decoder
//     usually falls onto the true code boundaries within a few symbols; a
//     code that never does, as one whose every code is 8 bits long, settles
//     lane by lane in at most 32 rounds, the serial chain's work).
//  3. Scan: a warp scan of the lanes' run codes (tokens) and symbols (each
//     run in full, one per literal) gives each lane its first token index
//     and its symbols emitted before.
//  4. Write: each lane decodes its codes again from its settled start and
//     writes its tokens, applying the serial chain's rules where it would:
//     a literal only while emitted + run < rlen, the chain's end at
//     emitted == rlen or after max_tokens tokens.  A lane past the end
//     writes nothing, so junk read past the row (its last word repeated)
//     never lands.
// The next window starts at the last lane's exit state.  The L1 tables, and
// the L2 table up to kSmemL2Max entries, sit in shared memory.
constexpr int kRunWarps = 4;                   // chains per block
constexpr int kLaneBits = 128;                 // bits a lane owns in a window
constexpr int kLaneCodes = 2 * kLaneBits + 2;  // codes a lane decodes at most

struct RunChain {
  Window win;
  const int* run1;
  const int* sym1;
  const int* l2;
  long long l2_len;
  int subw, lmax, nsignal;

  // One code at pos: its value (run length or literal), the position past
  // it, and the width of its last emission (16 after a run escape, 8 after
  // a literal escape).
  __device__ __forceinline__ int step(long long& pos, int phase, int& width) {
    const uint64_t w = win.at(pos);
    const int p = static_cast<int>(pos & 31);
    const int e = lookup(phase ? sym1 : run1, l2, l2_len, subw, lmax, bits_at(w, p, 16));
    const int nb = (e >> 9) & 31;
    const int sym = e & 511;
    if (phase == 0 && sym == 255) {  // run escape: a 16-bit run length follows
      pos += nb + 16;
      width = 16;
      return bits_at(w, p + nb, 16);
    }
    if (phase == 1 && sym == nsignal) {  // literal escape: 8 bits follow
      pos += nb + 8;
      width = 8;
      return bits_at(w, p + nb, 8);
    }
    pos += nb;
    width = nb;
    return sym;
  }
};

__global__ void __launch_bounds__(32 * kRunWarps)
decode_run_kernel(const uint32_t* __restrict__ rect, long long k,
                  const int* __restrict__ rlens, const int* __restrict__ pos0,
                  const int* __restrict__ carry, const int* __restrict__ f1r,
                  const int* __restrict__ f1s, const int* __restrict__ f2, long long f2_len,
                  int subw, int lmax, int nsignal, bool l2_smem, int* __restrict__ runs,
                  int* __restrict__ lits, int* __restrict__ bits_out,
                  int* __restrict__ last_out, int n_rows, long long max_tokens) {
  extern __shared__ int s_l2[];
  __shared__ int s_run[256];
  __shared__ int s_sym[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_run[i] = f1r[i];
    s_sym[i] = f1s[i];
  }
  if (l2_smem) stage_l2(s_l2, f2, f2_len);
  __syncthreads();
  const int row = blockIdx.x * kRunWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;

  RunChain ch{Window{rect + row * k, k, -2, 0u, 0u}, s_run, s_sym, l2_smem ? s_l2 : f2,
              f2_len, subw, lmax, nsignal};
  const long long rlen = rlens[row];
  int* rr = runs + row * max_tokens;
  int* lr = lits + row * max_tokens;
  long long pos = pos0 ? pos0[row] : 0;  // the chain's state between windows
  int phase = 0;
  long long tok = 0, em = 0;             // tokens begun, symbols emitted
  long long end_pos = pos;
  int end_last = 0;
  bool done = rlen <= 0 || max_tokens <= 0;
  const int cr = carry ? carry[row] : -1;
  if (!done && cr >= 0) {  // resume inside a run: token 0 is (carry, literal at pos)
    tok = 1;
    em = cr;
    phase = 1;
    if (lane == 0) rr[0] = cr;
    if (em >= rlen) {  // no literal: the width of the run code at pos, unread
      long long p = pos;
      ch.step(p, 0, end_last);
      if (lane == 0) lr[0] = -1;
      done = true;
    }
  }

  while (!done) {
    const long long w0 = pos;
    const long long lane_end = w0 + static_cast<long long>(lane + 1) * kLaneBits;
    long long spos = lane == 0 ? pos : w0 + static_cast<long long>(lane) * kLaneBits;
    int sph = lane == 0 ? phase : 0;
    long long xpos;
    int xph, n_tok;
    long long n_em;
    for (;;) {  // speculate, then synchronise until no start changes
      xpos = spos;
      xph = sph;
      n_tok = 0;
      n_em = 0;
      for (int c = 0; c < kLaneCodes && xpos < lane_end; ++c) {
        int width;
        const int val = ch.step(xpos, xph, width);
        if (xph == 0) {
          ++n_tok;
          n_em += val;
        } else {
          ++n_em;
        }
        xph ^= 1;
      }
      long long npos = __shfl_up_sync(kAll, xpos, 1);
      int nph = __shfl_up_sync(kAll, xph, 1);
      if (lane == 0) {
        npos = spos;
        nph = sph;
      }
      const bool moved = npos != spos || nph != sph;
      spos = npos;
      sph = nph;
      if (!__any_sync(kAll, moved)) break;
    }
    // exclusive scans of the lanes' tokens and symbols
    long long t_inc = n_tok, e_inc = n_em;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long t = __shfl_up_sync(kAll, t_inc, d);
      const long long e = __shfl_up_sync(kAll, e_inc, d);
      if (lane >= d) {
        t_inc += t;
        e_inc += e;
      }
    }
    long long tc = tok + t_inc - n_tok, ec = em + e_inc - n_em;
    // the write pass
    bool ends = false;
    long long fpos = 0;
    int flast = 0;
    {
      long long p = spos;
      int ph = sph;
      for (int c = 0; c < kLaneCodes && p < lane_end; ++c) {
        if (ph == 0 ? (tc >= max_tokens || ec >= rlen) : (ec >= rlen || tc > max_tokens)) {
          break;  // past the chain's end
        }
        int width;
        const int val = ch.step(p, ph, width);
        if (ph == 0) {
          rr[tc] = val;
          ++tc;
          ec += val;
          if (ec >= rlen) {  // the last token: its run reaches rlen, no literal
            lr[tc - 1] = -1;
            ends = true;
          }
        } else {
          lr[tc - 1] = val;
          ++ec;
          ends = ec >= rlen || tc >= max_tokens;
        }
        if (ends) {
          fpos = p;
          flast = width;
          break;
        }
        ph ^= 1;
      }
    }
    const unsigned enders = __ballot_sync(kAll, ends);
    if (enders) {
      const int src = __ffs(enders) - 1;
      end_pos = __shfl_sync(kAll, fpos, src);
      end_last = __shfl_sync(kAll, flast, src);
      tok = __shfl_sync(kAll, tc, src);
      done = true;
    } else {
      pos = __shfl_sync(kAll, xpos, 31);
      phase = __shfl_sync(kAll, xph, 31);
      tok += __shfl_sync(kAll, t_inc, 31);
      em += __shfl_sync(kAll, e_inc, 31);
    }
  }
  for (long long t = tok + lane; t < max_tokens; t += 32) {  // padding tokens
    rr[t] = 0;
    lr[t] = -1;
  }
  if (lane == 0) {
    bits_out[row] = static_cast<int>(end_pos);
    last_out[row] = end_last;
  }
}

// dst[0, n) = src[0, n) by the 32 lanes of a warp, src in shared memory at
// the same address mod 16 as dst: 16-byte stores where the address allows,
// single bytes at the two ends.
__device__ __forceinline__ void warp_copy(uint8_t* dst, const uint8_t* src, int n, int lane) {
  const int mis = (16 - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  const int body = mis < n ? mis : n;
  const int end = body + ((n - body) & ~15);
  if (lane < body) dst[lane] = src[lane];
  for (int i = body + 16 * lane; i < end; i += 16 * 32) {
    *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
  }
  if (lane < n - end) dst[end + lane] = src[end + lane];
}

// Columns as unsigned sums that stop at kColCap: max_len and n_tokens are at
// most kColCap, so a column that reaches it lies past the row either way,
// and a column, a capped sum plus a token index, stays below 2^31.
__device__ __forceinline__ uint32_t cap_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;   // both <= kColCap: no wrap
  return s < static_cast<uint32_t>(kColCap) ? s : static_cast<uint32_t>(kColCap);
}

// K6: kRowWarps warps a row (1, or the whole block), kWarps / kRowWarps rows
// a block.  A row's tokens go in rounds of kRowWarps slices of 32 *
// kLaneTokens, one slice a warp, kLaneTokens consecutive tokens a lane,
// loaded at once (16-byte loads where the planes allow).  Token k owns the
// columns [cumsum(runs)[k-1] + k, cumsum(runs)[k] + k]: its run of rchar,
// then its literal's column.  So a slice owns one span of columns, found by
// a warp scan of its runs and, with several warps a row, a scan of the
// slices' sums through shared memory (one barrier a round).  Each lane keeps
// its literals' columns and low bytes, -1 for no literal.  The warp builds
// its span in windows of kWin columns in its own shared memory, rchar (and
// -1) first, then its literals and their tag letters, and writes each
// window's columns once, at the window's alignment in shared memory so that
// the body goes as 16-byte stores.  The columns past the last token's are
// rchar (and -1), written without staging.  Runs are >= 0 (every producer's
// contract), so columns grow with the token index: a round that starts at
// or past max_len ends the row.
template <int kWarps, int kRowWarps, int kLaneTokens, int kWin>
__global__ void __launch_bounds__(32 * kWarps)
expand_runs_kernel(const int* __restrict__ runs, const int* __restrict__ lits,
                   long long n_tokens, int rchar, const uint8_t* __restrict__ tag_bytes,
                   long long tag_width, uint8_t* __restrict__ rows, int8_t* __restrict__ tags,
                   int n_rows, long long max_len) {
  constexpr int kSlot = kWin + 16;
  constexpr int kSlice = 32 * kLaneTokens;
  __shared__ __align__(16) uint8_t s_row[kWarps][kSlot];
  __shared__ __align__(16) uint8_t s_tag[kWarps][kSlot];
  __shared__ uint32_t s_sum[2][kRowWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kWarps / kRowWarps) + warp / kRowWarps;
  const int part = warp % kRowWarps;   // the warp's slice of a round
  if (row >= n_rows) return;           // (several warps a row: the grid is exact)
  uint8_t* out = rows + row * max_len;
  uint8_t* tout = tags ? reinterpret_cast<uint8_t*>(tags) + row * max_len : nullptr;
  const int* rr = runs + row * n_tokens;
  const int* lr = lits + row * n_tokens;
  const uint8_t* tb = tag_bytes ? tag_bytes + row * tag_width : nullptr;
  const bool vec = (n_tokens & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(runs) | reinterpret_cast<uintptr_t>(lits)) & 15) == 0;
  const bool tvec = (tag_width & 3) == 0 && (reinterpret_cast<uintptr_t>(tag_bytes) & 3) == 0;
  const uint8_t rc = static_cast<uint8_t>(rchar);
  const uint32_t letters = 'a' | ('c' << 8) | ('g' << 16) | ('t' << 24);
  uint8_t* srow = s_row[warp];
  uint8_t* stag = s_tag[warp];
  uint32_t carry = 0;   // the runs of the rounds before, capped
  long long k0 = 0;
  for (int rd = 0; k0 < n_tokens; ++rd, k0 += static_cast<long long>(kRowWarps) * kSlice) {
    if (carry + k0 >= max_len) break;   // the round's first column: the rest is dropped
    const long long a = k0 + static_cast<long long>(part) * kSlice;   // the slice
    const long long kl = a + lane * kLaneTokens;                     // the lane's tokens
    // col[i]: first the lane's capped inclusive run sums, then token kl + i's
    // column, 0xffffffff without a literal; lb: the literals' low bytes
    uint32_t col[kLaneTokens], lb[kLaneTokens / 4];
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kLaneTokens / 4; ++q) {
      int4 r4 = make_int4(0, 0, 0, 0), l4 = make_int4(-1, -1, -1, -1);
      const long long k = kl + 4 * q;
      if (vec) {
        if (k < n_tokens) {
          r4 = *reinterpret_cast<const int4*>(rr + k);
          l4 = *reinterpret_cast<const int4*>(lr + k);
        }
      } else {
        if (k < n_tokens) { r4.x = rr[k]; l4.x = lr[k]; }
        if (k + 1 < n_tokens) { r4.y = rr[k + 1]; l4.y = lr[k + 1]; }
        if (k + 2 < n_tokens) { r4.z = rr[k + 2]; l4.z = lr[k + 2]; }
        if (k + 3 < n_tokens) { r4.w = rr[k + 3]; l4.w = lr[k + 3]; }
      }
      const int rv[4] = {r4.x, r4.y, r4.z, r4.w};
      const int lv[4] = {l4.x, l4.y, l4.z, l4.w};
      uint32_t b = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t run = static_cast<uint32_t>(rv[e]);
        sum = cap_add(sum, run < static_cast<uint32_t>(kColCap) ? run : static_cast<uint32_t>(kColCap));
        col[4 * q + e] = lv[e] >= 0 ? sum : 0xffffffffu;
        b |= static_cast<uint32_t>(lv[e] & 0xff) << (8 * e);
      }
      lb[q] = b;
    }
    // the lane's tag codes, token kl + i at bits 31 - 2(i & 15) of word i >> 4
    // (code k: byte k >> 2, first code in bits 7-6; codes past 4 * tag_width read 0)
    constexpr int kCodeWords = (kLaneTokens + 15) / 16;
    uint32_t codes[kCodeWords];
#pragma unroll
    for (int h = 0; h < kCodeWords; ++h) {
      codes[h] = 0;
      if (tout) {
        const long long b0 = (kl >> 2) + 4 * h;
        if (kLaneTokens % 16 == 0 && tvec && b0 + 4 <= tag_width) {
          codes[h] = __byte_perm(*reinterpret_cast<const uint32_t*>(tb + b0), 0u, 0x0123);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * (4 * h + i) < kLaneTokens && b0 + i < tag_width) {
              codes[h] |= static_cast<uint32_t>(tb[b0 + i]) << (24 - 8 * i);
            }
          }
        }
      }
    }
    uint32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = cap_add(incl, t);
    }
    const uint32_t slice = __shfl_sync(0xffffffffu, incl, 31);
    uint32_t excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0;
    uint32_t before = carry;   // the runs before the slice
    if (kRowWarps > 1) {
      if (lane == 0) s_sum[rd & 1][part] = slice;
      __syncthreads();
      uint32_t total = 0;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) {
        const uint32_t v = s_sum[rd & 1][w];
        if (w < part) before = cap_add(before, v);
        total = cap_add(total, v);
      }
      carry = cap_add(carry, total);
    } else {
      carry = cap_add(carry, slice);
    }
    if (a >= n_tokens) continue;
    const long long b = a + kSlice < n_tokens ? a + kSlice : n_tokens;
    const long long lo = before + a;   // the slice's columns [lo, hi)
    const long long hi0 = static_cast<long long>(cap_add(before, slice)) + b;
    const long long hi = hi0 < max_len ? hi0 : max_len;
    const uint32_t pre = cap_add(before, excl);
#pragma unroll
    for (int i = 0; i < kLaneTokens; ++i) {
      if (col[i] != 0xffffffffu) col[i] = cap_add(pre, col[i]) + static_cast<uint32_t>(kl + i);
    }
    for (long long c0 = lo; c0 < hi; c0 += kWin) {
      const int n = static_cast<int>(hi - c0 < kWin ? hi - c0 : kWin);
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(out + c0) & 15);
      const int mist = tout ? static_cast<int>(reinterpret_cast<uintptr_t>(tout + c0) & 15) : 0;
      const uint32_t f4 = rc * 0x01010101u;
      for (int i = 16 * lane; i < mis + n; i += 16 * 32) {
        *reinterpret_cast<uint4*>(srow + i) = make_uint4(f4, f4, f4, f4);
      }
      if (tout) {
        for (int i = 16 * lane; i < mist + n; i += 16 * 32) {
          *reinterpret_cast<uint4*>(stag + i) = make_uint4(~0u, ~0u, ~0u, ~0u);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kLaneTokens; ++i) {
        const uint32_t x = col[i] - static_cast<uint32_t>(c0);   // wraps below c0
        if (x < static_cast<uint32_t>(n)) {
          srow[mis + x] = static_cast<uint8_t>(lb[i >> 2] >> (8 * (i & 3)));
          if (tout) {
            const uint32_t code = (codes[i >> 4] >> (30 - 2 * (i & 15))) & 3u;
            stag[mist + x] = static_cast<uint8_t>(letters >> (8 * code));
          }
        }
      }
      __syncwarp();
      warp_copy(out + c0, srow + mis, n, lane);
      if (tout) warp_copy(tout + c0, stag + mist, n, lane);
      __syncwarp();
    }
  }
  // the columns past the last token's (none where a round ended the row)
  const long long tail = carry + (k0 < n_tokens ? k0 : n_tokens);
  if (tail < max_len) {
    const long long per = ((max_len - tail + kRowWarps - 1) / kRowWarps + 15) & ~15LL;
    const long long from = tail + part * per;
    const long long to = from + per < max_len ? from + per : max_len;
    warp_fill(out, from, to, rc, lane);
    if (tout) warp_fill(tout, from, to, 0xFF, lane);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/_build.py).  Each launches on
// the given stream, never synchronises, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).

extern "C" int dxt_decode_plain(int channels, const void* rects, const void* k_words,
                                const void* signals, const void* subws, const void* rlens,
                                const void* pos0, const void* f1, const void* f2,
                                long long f2_len, int lmax, void* syms, void* bits,
                                void* last, int n_rows, long long max_len, void* stream) {
  if (channels <= 0 || n_rows <= 0) return 0;
  if (channels > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  PlainChannels ch;
  bool any_l2 = false;
  for (int c = 0; c < channels; ++c) {
    ch.rect[c] = static_cast<const uint32_t* const*>(rects)[c];
    ch.k[c] = static_cast<const long long*>(k_words)[c];
    ch.signal[c] = static_cast<const int*>(signals)[c];
    ch.subw[c] = static_cast<const int*>(subws)[c];
    any_l2 = any_l2 || ch.subw[c] > 0;
  }
  const bool l2_smem = any_l2 && f2_len <= kSmemL2Max;
  const size_t smem = l2_smem ? static_cast<size_t>(f2_len) * sizeof(int) : 0;
  const dim3 grid(static_cast<unsigned>((n_rows + kPlainWarps - 1) / kPlainWarps),
                  static_cast<unsigned>(channels));
  decode_plain_kernel<<<grid, 32 * kPlainWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      ch, static_cast<const int*>(rlens), static_cast<const int*>(pos0),
      static_cast<const int*>(f1), static_cast<const int*>(f2), f2_len, lmax, l2_smem,
      static_cast<uint8_t*>(syms), static_cast<int*>(bits), static_cast<int*>(last), n_rows,
      max_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxt_decode_run(const void* rect, long long k, const void* rlens, const void* pos0,
                              const void* carry, const void* f1r, const void* f1s,
                              const void* f2, long long f2_len, int subw, int lmax, int nsignal,
                              void* runs, void* lits, void* bits, void* last, int n_rows,
                              long long max_tokens, void* stream) {
  if (n_rows <= 0) return 0;
  const bool l2_smem = subw > 0 && f2_len <= kSmemL2Max;
  const size_t smem = l2_smem ? static_cast<size_t>(f2_len) * sizeof(int) : 0;
  decode_run_kernel<<<static_cast<unsigned>((n_rows + kRunWarps - 1) / kRunWarps),
                      32 * kRunWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rect), k, static_cast<const int*>(rlens),
      static_cast<const int*>(pos0), static_cast<const int*>(carry),
      static_cast<const int*>(f1r), static_cast<const int*>(f1s), static_cast<const int*>(f2),
      f2_len, subw, lmax, nsignal, l2_smem, static_cast<int*>(runs), static_cast<int*>(lits),
      static_cast<int*>(bits), static_cast<int*>(last), n_rows, max_tokens);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxt_expand_runs(const void* runs, const void* lits, long long n_tokens, int rchar,
                               const void* tag_bytes, long long tag_width, void* rows, void* tags,
                               int n_rows, long long max_len, void* stream) {
  if (n_rows <= 0 || max_len <= 0) return 0;
  if (max_len > kColCap || n_tokens > kColCap) return static_cast<int>(cudaErrorInvalidValue);
  const auto r = static_cast<const int*>(runs);
  const auto l = static_cast<const int*>(lits);
  const auto tb = static_cast<const uint8_t*>(tag_bytes);
  const auto o = static_cast<uint8_t*>(rows);
  const auto t = static_cast<int8_t*>(tags);
  const auto s = static_cast<cudaStream_t>(stream);
  // a warp a row while its tokens take one slice of 32 a lane and the rows
  // give each SM four warps or more; fewer rows take a block of 8 warps a
  // row, 4 tokens a lane, for shorter chains.  Wider rows take a block of 8
  // warps of 16 a lane for one round, past it one of 32 warps of 8 a lane
  // (more would spill at 1,024 threads).
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (n_tokens <= 32 * 32 && n_rows >= 4 * sms) {
    expand_runs_kernel<4, 1, 32, 4096><<<static_cast<unsigned>((n_rows + 3) / 4), 128, 0, s>>>(
        r, l, n_tokens, rchar, tb, tag_width, o, t, n_rows, max_len);
  } else if (n_tokens <= 32 * 32) {
    expand_runs_kernel<8, 8, 4, 2048><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
        r, l, n_tokens, rchar, tb, tag_width, o, t, n_rows, max_len);
  } else if (n_tokens <= 8 * 32 * 16) {
    expand_runs_kernel<8, 8, 16, 2048><<<static_cast<unsigned>(n_rows), 256, 0, s>>>(
        r, l, n_tokens, rchar, tb, tag_width, o, t, n_rows, max_len);
  } else {
    expand_runs_kernel<32, 32, 8, 512><<<static_cast<unsigned>(n_rows), 1024, 0, s>>>(
        r, l, n_tokens, rchar, tb, tag_width, o, t, n_rows, max_len);
  }
  return static_cast<int>(cudaGetLastError());
}
