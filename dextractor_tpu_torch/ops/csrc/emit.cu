// Hand-written Hopper kernels (sm_90a) of the .dexqv encode path.
//
//   dxt_encode_plain  K1, replaces dextractor_tpu/ops/emit_pallas.py::encode_plain_pallas
//   dxt_encode_run    K2, replaces dextractor_tpu/ops/emit_pallas.py::encode_run_pallas
//   dxt_pack_tags     K3, replaces dextractor_tpu/ops/emit_pallas.py::pack_tags_pallas
//   dxt_pack_words    K8, replaces dextractor_tpu/ops/pack_pallas.py::pack_words_pallas
//   dxt_lut_gather    K9 and K9b, replace dextractor_tpu/ops/lut_pallas.py::lut_gather_lane
//                     and ::lut_gather_pallas (one function, two formulations)
//
// K8 and K9 serve the emission route of the encode step (buckets that
// emit.fused_ok sends past K1/K2): K9 looks up every symbol and run length
// in a 256-entry table, plain PyTorch builds the (value, width) emission
// planes from the entries (bitstream_torch.plain_emissions /
// run_emissions), and K8 packs the planes into words.  K9 is one pass over
// the flat elements with the 1 KB table in shared memory, four indices a
// thread and step; an index is masked to its low byte, so an input outside
// the function's domain [0, 256) reads the table and not past it.  K8
// packs the emission planes into every word of its (N, M+1) output, zeros
// past a row's last bit, with each row cut into tiles across blocks (see
// pack_words_kernel).  Both are bound by bytes: K9 reads 1 (u8) or 4 (int32)
// bytes and writes 4 per element, K8 reads 8 bytes a slot and writes 4 a
// word.
//
// What they compute is the JAX package's XLA formulation, not its Pallas
// bodies: bitstream_jax.plain_emissions / run_emissions + pack_words (the
// reference's 32-bit OCODE emitter, QV.c:386-506) and pipeline._pack_tags
// (Pack_Tag + Number_Read + Compress_Read, QV.c:810-819).  The plain PyTorch
// twins in ops/bitstream_torch.py and parallel/pipeline.py compute the same
// functions; chip_smoke.py holds each kernel against its twin bit for bit.
//
// Bound on the H100: by bytes, device memory.  A symbol is one byte in; K1
// writes at most 24 bits for it (usually 4-6), K2 at most 56 per literal,
// K3 2 bits.  The work per symbol is one 256-entry LUT lookup, a few shifts
// and a share of a scan.  At 2,000-symbol rows instruction issue and the
// latency of the scans and barriers, not memory, bound them (PERF.md,
// Findings).  K1 (see encode_plain_kernel) gives each tile of a row (the
// row's width, or narrower where a launch has few rows) to one warp: a
// shuffle scan of the lanes' widths a step at a time, each lane's words
// built in a register and ORed once into a per-warp shared window, no block
// barrier; the tiles of a wider row chain by K8's decoupled look-back.  K2
// and K3:
// one thread block owns one (channel, row) and walks it in chunks of kChunk
// symbols, four per thread.  A block scan of the emission widths (carried
// across chunks) gives every emission its bit offset; K2 first runs a
// max-scan of literal positions to recover each literal's preceding run
// (bitstream_jax.py:126).  Emissions are ORed into a shared-memory window
// with shared atomics, and each finished 32-bit word (byte for K3) goes to
// device memory exactly once, coalesced.  Nothing is zero-filled: K1/K2
// leave the words past a row's ceil(t/32) unwritten (callers read rows up to
// that count), K3 writes its whole row including the zero tail.  The TPU
// kernels' 8,192-column VMEM cap does not apply: a row of any width streams
// through the same window.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

using dxt::MaxOp;
using dxt::SumOp;

template <class Op>
__device__ __forceinline__ int block_scan(int x, int identity, Op op, int* s_warp,
                                          int* total) {
  return dxt::block_scan<kThreads>(x, identity, op, s_warp, total);
}

struct Emission {
  uint32_t v;  // value, right-aligned
  int n;       // width in bits (<= 32)
  int gran;    // width of its last granule: 8/16 after an escape, else n
};

// Packed LUT entry: bits << 6 | len << 1 | esc (bitstream_jax.scheme_luts).
// An escape is code || 8-bit literal (Encode, QV.c:397-402).
__device__ __forceinline__ Emission sym_emission(const int* lut, int sym) {
  const int pk = lut[sym];
  const uint32_t bits = static_cast<uint32_t>(pk) >> 6;
  const int len = (pk >> 1) & 31;
  if (pk & 1) return {(bits << 8) | static_cast<uint32_t>(sym), len + 8, 8};
  return {bits, len, len};
}

// Run code of min(run, 255); an escape is code || (run & 0xFFFF)
// (Encode_Run, QV.c:468-487).
__device__ __forceinline__ Emission run_emission(const int* lut, int run) {
  const int pk = lut[run < 255 ? run : 255];
  const uint32_t bits = static_cast<uint32_t>(pk) >> 6;
  const int len = (pk >> 1) & 31;
  if (pk & 1) {
    return {(bits << 16) | (static_cast<uint32_t>(run) & 0xFFFFu), len + 16, 16};
  }
  return {bits, len, len};
}

// OR an emission of n >= 1 bits into the MSB-first word window at bit offset
// `bit`; it touches at most two words.
__device__ __forceinline__ void put_bits(uint32_t* s, int bit, uint32_t v, int n) {
  const int w = bit >> 5;
  const int pn = (bit & 31) + n;
  if (pn <= 32) {
    atomicOr(&s[w], v << (32 - pn));
  } else {
    atomicOr(&s[w], v >> (pn - 32));
    atomicOr(&s[w + 1], v << (64 - pn));
  }
}

// The window s holds the row's bits [32 * (carry >> 5), end).  Write its
// finished words to dst and move the unfinished one to s[0].
__device__ __forceinline__ void flush_words(uint32_t* s, uint32_t* dst,
                                            long long carry, long long end) {
  __syncthreads();  // every OR into s is done
  const long long base = carry >> 5;
  const int full = static_cast<int>((end >> 5) - base);
  for (int i = threadIdx.x; i < full; i += kThreads) dst[base + i] = s[i];
  const uint32_t part = s[full];
  __syncthreads();
  for (int i = threadIdx.x; i <= full; i += kThreads) s[i] = i == 0 ? part : 0u;
  __syncthreads();
}

__device__ __forceinline__ int clamp_len(int len, long long width) {
  if (len < 0) return 0;
  return len > width ? static_cast<int>(width) : len;
}

__global__ void __launch_bounds__(kThreads)
encode_run_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                  const int* __restrict__ sym_luts, const int* __restrict__ run_luts,
                  const int* __restrict__ rchars, uint32_t* __restrict__ words,
                  int* __restrict__ t_out, int* __restrict__ lg_out, int n_rows,
                  long long width, long long mp) {
  constexpr int kStage = 2 * kChunk + 2;  // <= 64 bits per literal, plus the carry word
  __shared__ int s_slut[256];
  __shared__ int s_rlut[256];
  __shared__ uint32_t s_stage[kStage];
  __shared__ int s_warp[kWarps];

  const int row = blockIdx.x;
  const int ch = blockIdx.y;
  const long long r = static_cast<long long>(ch) * n_rows + row;
  const uint8_t* src = data + r * width;
  uint32_t* dst = words + r * mp;
  const int len = clamp_len(lengths[row], width);
  const int rchar = rchars[ch];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    s_slut[i] = sym_luts[ch * 256 + i];
    s_rlut[i] = run_luts[ch * 256 + i];
  }
  for (int i = threadIdx.x; i < kStage; i += kThreads) s_stage[i] = 0u;
  __syncthreads();

  long long carry = 0;
  int last_lit = -1;  // column of the last literal in earlier chunks
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    int sym[kItems];
    int mx = -1;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int col = c0 + threadIdx.x * kItems + k;
      sym[k] = col < len ? src[col] : rchar;
      if (col < len && sym[k] != rchar) mx = col;
    }
    int chunk_last;
    int prev = block_scan(mx, -1, MaxOp(), s_warp, &chunk_last);
    if (last_lit > prev) prev = last_lit;

    Emission re[kItems], se[kItems];
    int tot = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int col = c0 + threadIdx.x * kItems + k;
      re[k] = {0u, 0, 0};
      se[k] = {0u, 0, 0};
      if (col < len && sym[k] != rchar) {  // one (run, literal) pair per literal
        re[k] = run_emission(s_rlut, col - prev - 1);
        se[k] = sym_emission(s_slut, sym[k]);
        prev = col;
      }
      tot += re[k].n + se[k].n;
    }
    int total;
    int bit = static_cast<int>(carry & 31) + block_scan(tot, 0, SumOp(), s_warp, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (re[k].n) put_bits(s_stage, bit, re[k].v, re[k].n);
      bit += re[k].n;
      if (se[k].n) put_bits(s_stage, bit, se[k].v, se[k].n);
      bit += se[k].n;
    }
    const long long end = carry + total;
    flush_words(s_stage, dst, carry, end);
    carry = end;
    if (chunk_last > last_lit) last_lit = chunk_last;
  }

  if (threadIdx.x == 0) {
    // the trailing run after the last literal, when it is not empty
    const int trail = len - last_lit - 1;
    long long t = carry;
    int lg = 0;
    if (trail > 0) {
      const Emission te = run_emission(s_rlut, trail);
      if (te.n) put_bits(s_stage, static_cast<int>(carry & 31), te.v, te.n);
      t += te.n;
      lg = te.gran;
    } else if (last_lit >= 0) {
      lg = sym_emission(s_slut, src[last_lit]).gran;
    }
    const long long base = carry >> 5;
    for (long long w = base; w < ((t + 31) >> 5); ++w) dst[w] = s_stage[w - base];
    t_out[r] = static_cast<int>(t);
    lg_out[r] = lg;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_tags_kernel(const uint8_t* __restrict__ tags, const uint8_t* __restrict__ dels,
                 const int* __restrict__ lengths, const int* __restrict__ del_char_p,
                 const uint8_t* __restrict__ number_lut, uint8_t* __restrict__ packed,
                 int* __restrict__ clens, long long width, long long wbytes) {
  constexpr int kStage = kChunk / 4 + 2;  // one slot per packed byte, plus the carry byte
  __shared__ uint32_t s_lut[256];
  __shared__ uint32_t s_stage[kStage];
  __shared__ int s_warp[kWarps];

  const long long row = blockIdx.x;
  const uint8_t* tg = tags + row * width;
  const uint8_t* dl = dels + row * width;
  uint8_t* dst = packed + row * wbytes;
  const int len = clamp_len(lengths[row], width);
  const int del_char = *del_char_p;
  for (int i = threadIdx.x; i < 256; i += kThreads) s_lut[i] = number_lut[i];
  for (int i = threadIdx.x; i < kStage; i += kThreads) s_stage[i] = 0u;
  __syncthreads();

  long long carry = 0;  // tags kept by earlier chunks
  for (int c0 = 0; c0 < len; c0 += kChunk) {
    uint32_t code[kItems];
    bool keep[kItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int col = c0 + threadIdx.x * kItems + k;
      keep[k] = col < len && (del_char < 0 || dl[col] != del_char);
      code[k] = keep[k] ? s_lut[tg[col]] : 0u;
      cnt += keep[k];
    }
    int total;
    // rank relative to the first code of byte carry >> 2
    int rank = static_cast<int>(carry & 3) + block_scan(cnt, 0, SumOp(), s_warp, &total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (keep[k]) {  // first code in bits 7-6 (DB.c:334)
        atomicOr(&s_stage[rank >> 2], code[k] << (6 - 2 * (rank & 3)));
        ++rank;
      }
    }
    const long long end = carry + total;
    __syncthreads();
    const long long base = carry >> 2;
    const int full = static_cast<int>((end >> 2) - base);
    for (int i = threadIdx.x; i < full; i += kThreads) {
      dst[base + i] = static_cast<uint8_t>(s_stage[i]);
    }
    const uint32_t part = s_stage[full];
    __syncthreads();
    for (int i = threadIdx.x; i <= full; i += kThreads) s_stage[i] = i == 0 ? part : 0u;
    __syncthreads();
    carry = end;
  }
  if (threadIdx.x == 0) {
    if (carry & 3) dst[carry >> 2] = static_cast<uint8_t>(s_stage[0]);
    clens[row] = static_cast<int>(carry);
  }
  for (long long b = ((carry + 3) >> 2) + threadIdx.x; b < wbytes; b += kThreads) dst[b] = 0;
}

// K8: emissions (v, n), MSB-first at bit offset cumsum(n) - n of their row
// (QV.c:404-422); n in [0, 32] and v < 2^n.  Every word of the (N, mw)
// output is written once: the packed ones, then zeros up to mw.
//
// Design (the first of the two the redesign allowed: one pass with a
// decoupled look-back).  A row is cut into tiles of kTile slots, and each
// block takes one tile, so the widest long-read bucket (8 rows of 122,881
// slots) runs 248 blocks instead of 8.  Blocks take their tiles in ticket
// order from an atomic counter, row-major, so a tile never waits on one
// that has not started.  A tile places its emissions in shared words from
// local bit 0 (a block scan of the widths gives the offsets), publishes its
// aggregate, then looks back over its row's earlier tiles for its
// exclusive prefix, and publishes its inclusive prefix.  The look-back
// state is the pair (bit count, last <= 32 bits right-aligned), whose
// combine is associative: a word that straddles tiles, even three or more
// when tiles hold fewer than 32 bits (zero-width slots are legal), is
// written whole by the tile that holds its last bit, from the carried bits
// and its own.  The row's last tile writes the partial last word and the
// zeros.  Flags carry the launch's epoch, so the tile states need no
// memset between launches; the block that finishes last resets the ticket
// counter for the next launch on the stream.  Each tile state is
// published as its payload, a fence, then its flag with release order;
// readers load the flag with acquire order and the payload past L1.
constexpr int kTileThreads = 256;
constexpr int kTileItems = 16;
constexpr int kTile = kTileThreads * kTileItems;  // slots per tile
constexpr unsigned kAgg = 1u, kInc = 2u;           // flag = epoch << 2 | status

struct TileState {   // one per tile, 32 bytes
  unsigned flag, agg_n, agg_last, inc_n, inc_last, pad[3];
};

struct Carry {       // (bit count, last min(count, 32) bits right-aligned)
  unsigned n, last;
};

// The stream a followed by the stream b.
__device__ __forceinline__ Carry combine(Carry a, Carry b) {
  if (b.n >= 32) return {a.n + b.n, b.last};
  if (b.n == 0) return a;
  return {a.n + b.n, (a.last << b.n) | b.last};
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Publish a tile's aggregate (kAgg) or inclusive prefix (kInc): the payload,
// a fence, then the flag with release order.  One lane calls it.
__device__ __forceinline__ void publish(TileState* st, unsigned status, Carry c,
                                        unsigned epoch) {
  if (status == kAgg) {
    st->agg_n = c.n;
    st->agg_last = c.last;
  } else {
    st->inc_n = c.n;
    st->inc_last = c.last;
  }
  __threadfence();
  store_release(&st->flag, epoch << 2 | status);
}

// The exclusive prefix of tile k of a row whose tile states start at `row`,
// by the 32 lanes of a warp, all of which return it.  A warp's width of
// tiles at a time: lane j reads tile k - 1 - (base + j) of the row; wait
// until all it needs have a flag of this launch, then combine up to the
// nearest inclusive prefix.
__device__ __forceinline__ Carry look_back(const TileState* row, int k, unsigned epoch,
                                           int lane) {
  Carry excl{0u, 0u};
  for (int base = 0; base < k; base += 32) {
    const int j = k - 1 - base - lane;  // tile index in the row, < 0: none
    const TileState* p = row + (j < 0 ? 0 : j);
    unsigned f = 0u;
    for (;;) {
      f = j < 0 ? (epoch << 2 | kInc) : load_acquire(&p->flag);
      const bool ready = (f >> 2) == epoch && (f & 3u);
      if (__all_sync(0xffffffffu, ready)) break;
    }
    const bool inc = j >= 0 && (f & 3u) == kInc;
    Carry c{0u, 0u};
    if (j >= 0) {
      c = inc ? Carry{__ldcg(&p->inc_n), __ldcg(&p->inc_last)}
              : Carry{__ldcg(&p->agg_n), __ldcg(&p->agg_last)};
    }
    const unsigned incs = __ballot_sync(0xffffffffu, inc);
    const int stop = incs ? __ffs(incs) - 1 : 31;  // the nearest inclusive prefix
    if (lane > stop) c = Carry{0u, 0u};
    // lane 0 gathers lanes 0..stop; a higher lane is earlier in the stream
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Carry o{__shfl_down_sync(0xffffffffu, c.n, d),
                    __shfl_down_sync(0xffffffffu, c.last, d)};
      if (lane + d < 32) c = combine(o, c);
    }
    c.n = __shfl_sync(0xffffffffu, c.n, 0);
    c.last = __shfl_sync(0xffffffffu, c.last, 0);
    excl = combine(c, excl);
    if (incs) break;
  }
  return excl;
}

__global__ void __launch_bounds__(kTileThreads)
pack_words_kernel(const uint32_t* __restrict__ v, const int* __restrict__ n,
                  uint32_t* __restrict__ words, long long m, long long mw,
                  int tiles_per_row, long long n_tiles, unsigned epoch,
                  TileState* __restrict__ states, unsigned long long* __restrict__ counters) {
  __shared__ uint32_t s_loc[kTile + 1];  // <= 32 bits per slot, plus one word
  __shared__ int s_warp[kTileThreads / 32];
  __shared__ long long s_ticket;
  __shared__ Carry s_excl;

  if (threadIdx.x == 0) s_ticket = static_cast<long long>(atomicAdd(&counters[0], 1ULL));
  for (int i = threadIdx.x; i <= kTile; i += kTileThreads) s_loc[i] = 0u;
  __syncthreads();
  const long long ticket = s_ticket;
  const long long row = ticket / tiles_per_row;
  const int k = static_cast<int>(ticket % tiles_per_row);
  const long long lo = static_cast<long long>(k) * kTile;
  const uint32_t* vr = v + row * m;
  const int* nr = n + row * m;

  uint32_t val[kTileItems];
  int w[kTileItems];
  int tot = 0;
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    const long long col = lo + threadIdx.x * kTileItems + j;
    val[j] = col < m ? vr[col] : 0u;
    w[j] = col < m ? nr[col] : 0;
    tot += w[j];
  }
  int agg;
  int bit = dxt::block_scan<kTileThreads>(tot, 0, SumOp(), s_warp, &agg);
#pragma unroll
  for (int j = 0; j < kTileItems; ++j) {
    if (w[j]) put_bits(s_loc, bit, val[j], w[j]);
    bit += w[j];
  }
  __syncthreads();

  TileState* st = states + ticket;
  if (threadIdx.x < 32) {
    // the tile's aggregate: its bit count and last <= 32 bits
    const unsigned a_n = static_cast<unsigned>(agg);
    unsigned a_last = 0u;
    if (a_n) {
      const unsigned w1 = (a_n - 1) >> 5, r = a_n & 31;
      a_last = r ? (s_loc[w1] >> (32 - r)) | (w1 ? s_loc[w1 - 1] << r : 0u) : s_loc[w1];
    }
    const Carry a{a_n, a_last};
    Carry excl{0u, 0u};
    const int lane = threadIdx.x;
    if (k > 0) {
      if (lane == 0) publish(st, kAgg, a, epoch);
      excl = look_back(states + (ticket - k), k, epoch, lane);
    }
    if (lane == 0) {
      publish(st, kInc, combine(excl, a), epoch);
      s_excl = excl;
    }
  }
  __syncthreads();

  // words [s >> 5, e >> 5): local bits [32i - o, 32i - o + 32) with the
  // carried bits before local bit 0
  const Carry excl = s_excl;
  const long long s = excl.n, e = s + agg;
  const int o = static_cast<int>(s & 31);
  const bool last_tile = k == tiles_per_row - 1;
  const long long first = s >> 5;
  const long long n_words = (e >> 5) - first + (last_tile && (e & 31) ? 1 : 0);
  uint32_t* dst = words + row * mw;
  for (long long i = threadIdx.x; i < n_words; i += kTileThreads) {
    const uint32_t cur = s_loc[i];
    const uint32_t prev = i == 0 ? excl.last : s_loc[i - 1];
    dst[first + i] = o ? (prev << (32 - o)) | (cur >> o) : cur;
  }
  if (last_tile) {
    for (long long i = ((e + 31) >> 5) + threadIdx.x; i < mw; i += kTileThreads) dst[i] = 0u;
  }

  // the last block to finish resets the ticket counter for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&counters[1], 1ULL) == static_cast<unsigned long long>(n_tiles - 1)) {
      counters[0] = 0ULL;
      counters[1] = 0ULL;
      __threadfence();
    }
  }
}

// K1: warps over tiles of a row.  Each (channel, row) is cut into tiles (the
// row's width up to 4,096 symbols, narrower where a launch has too few rows
// to fill the card: see dxt_encode_plain), one warp a tile and
// kPlainTileWarps tiles a block.
// Each warp first unpacks its channel's LUT into a shared table of
// value << 6 | escape << 5 | width per symbol.  It walks its tile in steps
// of 32 x 8 symbols: each lane loads its 8 consecutive symbols (one
// vector load where the row allows, single bytes elsewhere) and looks each
// up once; a shuffle scan of the lanes' widths
// gives each lane its bit offset; each lane shifts its emissions into a
// 64-bit register, without a branch a symbol, and ORs each word it
// completes into a per-warp shared window once, under __syncwarp (no
// __syncthreads past the block's ticket); the window's finished words are
// stored coalesced and its partial last word carried to the next step;
// each step's symbols are loaded a step ahead.  A row of one tile (every
// row of the uniform batch) needs nothing else.  The tiles of a wider row
// chain by K8's decoupled look-back: a tile first folds its
// (bit count, last <= 32 bits), which it publishes unless it holds the
// row's last symbol; a later tile looks back for its exclusive prefix and
// starts its window with the carried bits.  A tile stores the words whose
// last bit it holds; the row's last tile also stores the partial last word
// and t, and the lane with the symbol len - 1 lg.  Tiles past the row's
// length do nothing.  Tiles come from a ticket counter only when a row has
// more than one; the tile states are K8's (the same scratch and epochs).
// A block holds 4 tiles, and at least 10 blocks fit an SM (48 registers a
// thread), so the uniform batch's ~5,000 tiles run in one wave.
constexpr int kPlainTileWarps = 4;                          // tiles per block
constexpr int kPlainMinBlocks = 10;                         // blocks an SM holds, at least
constexpr int kPlainTileMax = 4096;                         // symbols per tile, at most
constexpr int kPlainTileMin = 512;                          // and at least
constexpr long long kPlainMinTiles = 2048;                  // tiles a launch wants
constexpr int kPlainLaneSyms = 8;                           // symbols per lane and step
constexpr int kPlainStep = 32 * kPlainLaneSyms;             // symbols per warp step
constexpr int kPlainWinWords = kPlainStep * 24 / 32 + 2;    // <= 24 bits a symbol

// A lane's 8 symbols from p[i0] on, four to a word, those from n on zero:
// one 8-byte load where aligned and whole, single bytes else.
__device__ __forceinline__ void lane_syms(const uint8_t* p, int i0, int n,
                                          uint32_t (&w)[2]) {
  if (i0 + kPlainLaneSyms <= n && (reinterpret_cast<uintptr_t>(p + i0) & 7) == 0) {
    const uint2 x = *reinterpret_cast<const uint2*>(p + i0);
    w[0] = x.x;
    w[1] = x.y;
    return;
  }
  w[0] = w[1] = 0u;
#pragma unroll
  for (int i = 0; i < kPlainLaneSyms; ++i) {
    if (i0 + i < n) w[i >> 2] |= static_cast<uint32_t>(p[i0 + i]) << (8 * (i & 3));
  }
}

__global__ void __launch_bounds__(32 * kPlainTileWarps, kPlainMinBlocks)
encode_plain_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                    const int* __restrict__ luts, uint32_t* __restrict__ words,
                    int* __restrict__ t_out, int* __restrict__ lg_out, int n_rows,
                    long long width, long long mp, int tile_syms, int tiles_per_row,
                    long long n_tiles, unsigned epoch, TileState* __restrict__ states,
                    unsigned long long* __restrict__ counters) {
  __shared__ uint32_t s_em[kPlainTileWarps][256];
  __shared__ uint32_t s_win[kPlainTileWarps][kPlainWinWords];
  __shared__ long long s_ticket;
  constexpr unsigned kFull = 0xffffffffu;

  if (threadIdx.x == 0) {
    long long t = blockIdx.x;
    if (tiles_per_row > 1) {  // a tile may wait on earlier ones: take them in order
      t = static_cast<long long>(atomicAdd(&counters[0], 1ULL));
      __threadfence();
      if (atomicAdd(&counters[1], 1ULL) == gridDim.x - 1ULL) {  // every ticket taken
        counters[0] = 0ULL;
        counters[1] = 0ULL;
      }
    }
    s_ticket = t;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = s_ticket * kPlainTileWarps + warp;
  if (tile >= n_tiles) return;
  const long long r = tile / tiles_per_row;  // channel * n_rows + row
  const int k = static_cast<int>(tile - r * tiles_per_row);
  const int ch = static_cast<int>(r / n_rows);
  const int len = clamp_len(lengths[r - static_cast<long long>(ch) * n_rows], width);
  const int lo = k * tile_syms;
  if (k > 0 && lo >= len) return;
  const int hi = lo + tile_syms < len ? lo + tile_syms : len;
  const bool last_tile = hi == len;
  uint32_t* em = s_em[warp];
  for (int i = lane; i < 256; i += 32) {  // value << 6 | escape << 5 | width
    const Emission e = sym_emission(luts + ch * 256, i);
    em[i] = e.v << 6 | (luts[ch * 256 + i] & 1) << 5 | static_cast<uint32_t>(e.n);
  }
  const uint8_t* row = data + r * width;
  __syncwarp();

  Carry excl{0u, 0u};
  if (!last_tile || k > 0) {
    TileState* st = states + tile;
    Carry a{0u, 0u};
    if (!last_tile) {  // the tile's (bit count, last <= 32 bits), lanes in stream order
      for (int s0 = lo; s0 < hi; s0 += kPlainStep) {
        const int i0 = s0 + kPlainLaneSyms * lane;
        uint32_t w[2];
        lane_syms(row, i0, hi, w);
        Carry sc{0u, 0u};
#pragma unroll
        for (int i = 0; i < kPlainLaneSyms; ++i) {
          const uint32_t e = em[(w[i >> 2] >> (8 * (i & 3))) & 0xFF];
          if (i0 + i < hi) sc = combine(sc, Carry{e & 31u, e >> 6});
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const Carry o{__shfl_down_sync(kFull, sc.n, d), __shfl_down_sync(kFull, sc.last, d)};
          if (lane + d < 32) sc = combine(sc, o);
        }
        a = combine(a, Carry{__shfl_sync(kFull, sc.n, 0), __shfl_sync(kFull, sc.last, 0)});
      }
      if (lane == 0) publish(st, k > 0 ? kAgg : kInc, a, epoch);
    }
    if (k > 0) {
      excl = look_back(states + (tile - k), k, epoch, lane);
      if (!last_tile && lane == 0) publish(st, kInc, combine(excl, a), epoch);
    }
  }

  // the tile's bits, a warp step at a time: the window holds the row's
  // words from word bit >> 5 on, word 0 with the bits carried before bit
  uint32_t* win = s_win[warp];
  uint32_t* dst = words + r * mp;
  unsigned bit = excl.n;
  uint32_t carry = bit & 31 ? excl.last << (32 - (bit & 31)) : 0u;
  uint32_t next[2];  // the next step's symbols, loaded a step ahead
  lane_syms(row, lo + kPlainLaneSyms * lane, hi, next);
  for (int s0 = lo; s0 < hi; s0 += kPlainStep) {
    const int i0 = s0 + kPlainLaneSyms * lane;
    const int nv = static_cast<int>(hi - i0 < 0 ? 0 : (hi - i0 < kPlainLaneSyms ? hi - i0 : kPlainLaneSyms));
    uint32_t w[2];
    w[0] = next[0];
    w[1] = next[1];
    if (s0 + kPlainStep < hi) lane_syms(row, i0 + kPlainStep, hi, next);
    uint32_t e[kPlainLaneSyms];
    int tot = 0;
#pragma unroll
    for (int i = 0; i < kPlainLaneSyms; ++i) {
      e[i] = i < nv ? em[(w[i >> 2] >> (8 * (i & 3))) & 0xFF] : 0u;
      tot += e[i] & 31;
    }
    const int j = len - 1 - i0;  // the lane's index of the row's last symbol
    if (j >= 0 && j < kPlainLaneSyms) {
      uint32_t el = e[0];
#pragma unroll
      for (int i = 1; i < kPlainLaneSyms; ++i) el = j == i ? e[i] : el;
      lg_out[r] = el & 32 ? 8 : static_cast<int>(el & 31);
    }
    int inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += t;
    }
    const int step_bits = __shfl_sync(kFull, inc, 31);
    const int o = static_cast<int>(bit & 31);
    const int n_win = (o + step_bits + 31) >> 5;
    for (int i = lane; i < n_win; i += 32) win[i] = i == 0 ? carry : 0u;
    __syncwarp();
    {
      const int b = o + inc - tot;
      // the lane's bits in a 64-bit accumulator, the first b & 31 of them
      // zeros for the bits of the lanes before; ab bits not yet ORed out
      int wi = b >> 5, ab = b & 31;
      unsigned long long acc = 0ull;
#pragma unroll
      for (int i = 0; i < kPlainLaneSyms; ++i) {
        acc = (acc << (e[i] & 31)) | (e[i] >> 6);
        ab += static_cast<int>(e[i] & 31);
        if (ab >= 32) {
          ab -= 32;
          atomicOr(&win[wi], static_cast<uint32_t>(acc >> ab));
          ++wi;
        }
      }
      if (ab) atomicOr(&win[wi], static_cast<uint32_t>(acc << (32 - ab)));
    }
    __syncwarp();
    const int full = (o + step_bits) >> 5;
    uint32_t* d = dst + (bit >> 5);
    for (int i = lane; i < full; i += 32) d[i] = win[i];
    carry = full < n_win ? win[full] : 0u;
    __syncwarp();
    bit += step_bits;
  }
  if (last_tile && lane == 0) {
    if (bit & 31) dst[bit >> 5] = carry;
    t_out[r] = static_cast<int>(bit);
    if (len == 0) lg_out[r] = 0;
  }
}

__device__ __forceinline__ void load4(const uint8_t* p, long long q, int (&d)[4]) {
  const uchar4 x = reinterpret_cast<const uchar4*>(p)[q];
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

__device__ __forceinline__ void load4(const int* p, long long q, int (&d)[4]) {
  const int4 x = reinterpret_cast<const int4*>(p)[q];
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

// K9: out[i] = lut[data[i] & 255] over `count` flat elements.  kVec: the
// pointers are aligned for 4-element loads and 16-byte stores.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const T* __restrict__ data, const int* __restrict__ lut,
                  int* __restrict__ out, long long count) {
  __shared__ int s_lut[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_lut[i] = lut[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long quads = count >> 2;
    for (long long q = first; q < quads; q += stride) {
      int d[4];
      load4(data, q, d);
      reinterpret_cast<int4*>(out)[q] =
          make_int4(s_lut[d[0] & 255], s_lut[d[1] & 255], s_lut[d[2] & 255],
                    s_lut[d[3] & 255]);
    }
    done = quads << 2;
  }
  for (long long i = done + first; i < count; i += stride) {
    out[i] = s_lut[static_cast<int>(data[i]) & 255];
  }
}

template <typename T>
int launch_lut_gather(const T* data, const int* lut, int* out, long long count,
                      cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per_block = 4LL * kThreads;
  const long long blocks = (count + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
  if (vec) {
    lut_gather_kernel<T, true><<<grid, kThreads, 0, stream>>>(data, lut, out, count);
  } else {
    lut_gather_kernel<T, false><<<grid, kThreads, 0, stream>>>(data, lut, out, count);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/_build.py).  Each launches on
// the given stream, never synchronises, and returns cudaGetLastError().

// scratch and epoch: as dxt_pack_words' (K8 and K1 share them), with
// channels * n_rows * max(1, ceil(width / 512)) tile states.  The tile is
// the row's width in whole warp steps, at most 4,096 symbols, halved (to
// whole steps, 512 symbols at least) while the launch has fewer than
// kPlainMinTiles tiles: the uniform batch's rows are one tile each, with no
// ticket and no look-back, and a bucket of few wide rows is cut finer.
extern "C" int dxt_encode_plain(const void* data, const void* lengths, const void* luts,
                                void* words, void* t, void* lg, int channels, int n_rows,
                                long long width, long long mp, void* scratch, unsigned epoch,
                                void* stream) {
  if (channels <= 0 || n_rows <= 0) return 0;
  const long long rows = static_cast<long long>(channels) * n_rows;
  auto steps = [](long long n) { return (n + kPlainStep - 1) / kPlainStep * kPlainStep; };
  long long tile = steps(width > 0 ? width : 1);
  if (tile > kPlainTileMax) tile = kPlainTileMax;
  auto per_row = [&](long long ts) { return width > 0 ? (width + ts - 1) / ts : 1LL; };
  while (tile > kPlainTileMin && rows * per_row(tile) < kPlainMinTiles) {
    const long long half = steps(tile / 2);
    tile = half < kPlainTileMin ? kPlainTileMin : half;
  }
  const long long tpr = per_row(tile);
  const long long tiles = rows * tpr;
  const long long blocks = (tiles + kPlainTileWarps - 1) / kPlainTileWarps;
  if (blocks > 0x7fffffffLL || epoch == 0 || epoch >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* counters = static_cast<unsigned long long*>(scratch);
  encode_plain_kernel<<<static_cast<unsigned>(blocks), 32 * kPlainTileWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths),
      static_cast<const int*>(luts), static_cast<uint32_t*>(words), static_cast<int*>(t),
      static_cast<int*>(lg), n_rows, width, mp, static_cast<int>(tile), static_cast<int>(tpr),
      tiles, epoch,
      reinterpret_cast<TileState*>(counters + 2), counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxt_encode_run(const void* data, const void* lengths, const void* sym_luts,
                              const void* run_luts, const void* rchars, void* words, void* t,
                              void* lg, int channels, int n_rows, long long width,
                              long long mp, void* stream) {
  if (channels <= 0 || n_rows <= 0) return 0;
  const dim3 grid(static_cast<unsigned>(n_rows), static_cast<unsigned>(channels));
  encode_run_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths),
      static_cast<const int*>(sym_luts), static_cast<const int*>(run_luts),
      static_cast<const int*>(rchars), static_cast<uint32_t*>(words), static_cast<int*>(t),
      static_cast<int*>(lg), n_rows, width, mp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxt_pack_tags(const void* tags, const void* dels, const void* lengths,
                             const void* del_char, const void* number_lut, void* packed,
                             void* clens, int n_rows, long long width, long long wbytes,
                             void* stream) {
  if (n_rows <= 0) return 0;
  pack_tags_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tags), static_cast<const uint8_t*>(dels),
      static_cast<const int*>(lengths), static_cast<const int*>(del_char),
      static_cast<const uint8_t*>(number_lut), static_cast<uint8_t*>(packed),
      static_cast<int*>(clens), width, wbytes);
  return static_cast<int>(cudaGetLastError());
}

// scratch: two u64 counters, then one 32-byte tile state per tile (n_rows
// * max(1, ceil(m / 4096)) tiles), zeroed once when allocated and used by
// one stream; epoch: in [1, 2^30) and unlike the epoch of the launch before
// on the same scratch.
extern "C" int dxt_pack_words(const void* v, const void* n, void* words, int n_rows,
                              long long m, void* scratch, unsigned epoch, void* stream) {
  if (n_rows <= 0) return 0;
  const long long tiles = n_rows * (m > 0 ? (m + kTile - 1) / kTile : 1LL);
  if (tiles > 0x7fffffffLL || epoch == 0 || epoch >= (1u << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* counters = static_cast<unsigned long long*>(scratch);
  pack_words_kernel<<<static_cast<unsigned>(tiles), kTileThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(v), static_cast<const int*>(n),
      static_cast<uint32_t*>(words), m, m + 1, static_cast<int>(tiles / n_rows), tiles, epoch,
      reinterpret_cast<TileState*>(counters + 2), counters);
  return static_cast<int>(cudaGetLastError());
}

// is_u8: data is uint8, else int32.
extern "C" int dxt_lut_gather(const void* data, int is_u8, const void* lut, void* out,
                              long long count, void* stream) {
  if (count <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_u8) {
    return launch_lut_gather(static_cast<const uint8_t*>(data), static_cast<const int*>(lut),
                             static_cast<int*>(out), count, st);
  }
  return launch_lut_gather(static_cast<const int*>(data), static_cast<const int*>(lut),
                           static_cast<int*>(out), count, st);
}
