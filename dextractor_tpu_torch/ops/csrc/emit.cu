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
// emit.fused_ok sends past K1/K2): K9 looks up the symbols and the run
// lengths in 256-entry tables, plain PyTorch builds the (value, width)
// emission planes from the entries (bitstream_torch.plain_emissions /
// run_assemble), and K8 packs the planes into words.  K9 takes every lookup
// of a bucket in one launch: up to eight groups (the four symbol planes,
// read straight from the stream rectangle, and the run planes of the RLE
// channels, min(run, 255) as u8), each with its own table, passed by value
// in the kernel's parameters.  Its grid is the tiles of all groups, 4,096
// elements a block, assigned to groups by the exclusive prefix of their
// tile counts (computed on the host); a block stages its group's 1 KB
// table in shared memory and each thread looks up 16 elements (see
// lut_gather_kernel).  An index is masked to its low byte, so an input
// outside the function's domain [0, 256) reads the table and not past it.
// K8 packs the emission planes into every word of its (N, M+1) output,
// zeros past a row's last bit, with each row cut into tiles across blocks
// (see pack_words_kernel).  Both are bound by bytes: K9 reads 1 (u8) or 4
// (int32) bytes and writes 4 per element, K8 reads 8 bytes a slot and
// writes 4 a word.  One launch of K9 a bucket, not one per lookup, is what
// lets the widest long-read bucket's lookups (five of 491,520 symbols) fill
// the card: the launch, the table fill and the tail were most of a
// one-lookup launch's time (PERF.md, Findings).
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
// K3 reads a tag and a delQV byte and writes 2 bits.  The work per symbol is
// a 256-entry table lookup, a few shifts and a share of a warp scan.  At
// 2,000-symbol rows instruction issue and the latency of the scans and of
// each warp's first loads, not memory, bound them (PERF.md, Findings).  K1, K2 and K3 share one design
// (see encode_plain_kernel): each (channel, row) is cut into tiles, one warp
// a tile; a warp walks its tile in steps of 32 lanes, a shuffle scan of the
// lanes' widths gives each lane its bit offset, each lane ORs its words into
// a per-warp shared window, and the window's finished words are stored
// coalesced, with no block barrier; the tiles of a wider row chain by K8's
// decoupled look-back (publish, look_back), so a bucket of few wide rows
// still fills the card.  K2's run before a tile's first literal needs the
// row's last literal before the tile, which the tiles publish first and
// find by a look-back of their own (look_back_lit).  Nothing is zero-filled
// by K1/K2: they leave the words past a row's ceil(t/32) unwritten (callers
// read rows up to that count); K3 writes its whole row, the zero tail
// included.  The TPU kernels' 8,192-column VMEM cap does not apply: a row
// of any width streams through the same window.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;

using dxt::SumOp;

// A symbol's entry of K1's and K2's shared tables, value << 6 | escape << 5
// | width, from its packed LUT entry pk = bits << 6 | len << 1 | esc
// (bitstream_jax.scheme_luts).  An escape is code || 8-bit literal
// (Encode, QV.c:397-402); codes are <= 16 bits, so a width is <= 24.
__device__ __forceinline__ uint32_t sym_entry(int pk, int sym) {
  const uint32_t bits = static_cast<uint32_t>(pk) >> 6;
  const uint32_t len = static_cast<uint32_t>(pk >> 1) & 31u;
  if (pk & 1) return (bits << 8 | static_cast<uint32_t>(sym)) << 6 | 32u | (len + 8u);
  return bits << 6 | len;
}

// Fill a warp's 256-entry shared table with f(entry i of the global table
// src, i): eight entries a lane, their loads issued together.
template <class T, class F>
__device__ __forceinline__ void fill_table(const T* src, uint32_t* dst, int lane, F f) {
  T x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = src[lane + 32 * j];
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[lane + 32 * j] = f(x[j], lane + 32 * j);
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

__device__ __forceinline__ int clamp_len(int len, long long width) {
  if (len < 0) return 0;
  return len > width ? static_cast<int>(width) : len;
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
  unsigned flag, agg_n, agg_last, inc_n, inc_last;
  unsigned lit_flag, lit, pad;  // K2: the epoch once lit, the tile's last literal, holds
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

constexpr unsigned kAllLanes = 0xffffffffu;

// The ticket of this block, thread 0 calls: its index when every row is one
// tile; else the next from the counter, so that a tile never waits on one
// that has not started, and the last block to take one resets the counters
// for the next launch on the stream.
__device__ __forceinline__ long long block_ticket(int tiles_per_row,
                                                  unsigned long long* counters) {
  if (tiles_per_row <= 1) return blockIdx.x;
  const long long t = static_cast<long long>(atomicAdd(&counters[0], 1ULL));
  __threadfence();
  if (atomicAdd(&counters[1], 1ULL) == gridDim.x - 1ULL) {  // every ticket taken
    counters[0] = 0ULL;
    counters[1] = 0ULL;
  }
  return t;
}

// The lanes' pairs folded in lane (stream) order, returned to every lane.
__device__ __forceinline__ Carry warp_fold(Carry c, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Carry o{__shfl_down_sync(kAllLanes, c.n, d), __shfl_down_sync(kAllLanes, c.last, d)};
    if (lane + d < 32) c = combine(c, o);
  }
  return Carry{__shfl_sync(kAllLanes, c.n, 0), __shfl_sync(kAllLanes, c.last, 0)};
}

// K1: warps over tiles of a row.  Each (channel, row) is cut into tiles (the
// row's width up to 4,096 symbols, narrower where a launch has too few rows
// to fill the card: see tile_launch), one warp a tile and
// kPlainTileWarps tiles a block.
// Each warp first loads the row's length, its first step's symbols (up to
// the tile's end in the row; the length masks them later) and its
// channel's LUT at once, and unpacks the LUT into a shared table of
// value << 6 | escape << 5 | width per symbol (fill_table: the loads of
// this prologue, one after another, cost a wide share of a uniform row's
// time).  It walks its tile in steps
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
// more than one (block_ticket); the tile states are K8's (the same scratch
// and epochs).  A block holds 4 tiles, and at least 10 blocks fit an SM (48
// registers a thread), so the uniform batch's ~5,000 tiles run in one wave.
constexpr int kPlainTileWarps = 4;                          // tiles per block
constexpr int kPlainMinBlocks = 10;                         // blocks an SM holds, at least
constexpr int kPlainTileMax = 4096;                         // symbols per tile, at most
constexpr int kPlainTileMin = 512;                          // and at least
constexpr long long kPlainMinTiles = 1024;                  // tiles a launch wants
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

  if (threadIdx.x == 0) s_ticket = block_ticket(tiles_per_row, counters);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = s_ticket * kPlainTileWarps + warp;
  if (tile >= n_tiles) return;
  const long long r = tile / tiles_per_row;  // channel * n_rows + row
  const int k = static_cast<int>(tile - r * tiles_per_row);
  const int ch = static_cast<int>(r / n_rows);
  const int lo = k * tile_syms;
  // the row's length, the tile's first symbols (up to the tile's end in the
  // row, masked by the length later) and the table load together
  const int len_in = lengths[r - static_cast<long long>(ch) * n_rows];
  const uint8_t* row = data + r * width;
  const int lim = lo + tile_syms < width ? lo + tile_syms : static_cast<int>(width);
  uint32_t next[2];  // the next step's symbols, loaded a step ahead
  lane_syms(row, lo + kPlainLaneSyms * lane, lim, next);
  uint32_t* em = s_em[warp];
  fill_table(luts + ch * 256, em, lane, [](int pk, int i) { return sym_entry(pk, i); });
  const int len = clamp_len(len_in, width);
  if (k > 0 && lo >= len) return;
  const int hi = lo + tile_syms < len ? lo + tile_syms : len;
  const bool last_tile = hi == len;
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
        a = combine(a, warp_fold(sc, lane));
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
      const int t = __shfl_up_sync(kAllLanes, inc, d);
      if (lane >= d) inc += t;
    }
    const int step_bits = __shfl_sync(kAllLanes, inc, 31);
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

// K2: K1's warps over tiles of a row, for an RLE channel (delQV, subQV).
// A literal is a symbol != rchar inside the row's length; it emits the code
// of the run of rchar before it (the columns since the row's last literal
// before it; min(run, 255) indexes the run table, and an escape appends
// run & 0xFFFF, QV.c:468-487), then its own code (bitstream_jax.py:120-146).
// The prologue is K1's.  A lane takes 16 symbols a step (one 16-byte load
// where the row allows, loaded a step ahead) and finds its literals as a
// bit mask by a SIMD byte compare; an exclusive warp max-scan of the lanes' last literal columns,
// seeded with the one carried from the steps before (-1: none yet), gives
// each lane the literal before its first symbol.  A lane then loops over
// its literals only (a QV channel's literals are its minority: a quarter
// of the symbols in the synthetic batches), once for the widths that the
// shuffle scan takes and once to emit.  Each emission is at most 32 bits
// (codes are <= 16 bits), so K1's 64-bit accumulator holds at most 31
// pending bits and one emission, and a check after each emission flushes
// at most one word.  Unlike K1's, a tile's bit count depends on the row's
// last literal before the tile.  That column is a function of the input
// alone: a tile that is not its row's last first finds its own last
// literal (a walk back from its end, one step unless the tile ends in a
// long run) and publishes it, and a later tile looks back over those for
// the nearest tile that has one (look_back_lit).  That costs a tile state
// per tile passed, where scanning the bytes back from the tile's start
// would cost the whole of a long run (an all-rchar row of 70,000 symbols:
// every tile the run so far).  Then the tiles fold, publish and look back
// over (bit count, last <= 32 bits) as K1's do.  The row's last tile also
// emits the trailing run after the row's last literal when it is not
// empty, stores the partial last word and t, and lg: the trailing run's
// last granule (16 after an escape, else its code length), else the last
// literal's (8 after an escape, else its code length), 0 for an empty row.

// Publish a tile's last literal column (-1: none), then its flag, the epoch.
__device__ __forceinline__ void publish_lit(TileState* st, int lit, unsigned epoch) {
  st->lit = static_cast<unsigned>(lit);
  __threadfence();
  store_release(&st->lit_flag, epoch);
}

// The row's last literal before tile k (-1: none), by the 32 lanes of a
// warp, all of which return it: lane j reads tile k - 1 - (base + j); wait
// until all have published, then take the nearest tile that has one.
__device__ __forceinline__ int look_back_lit(const TileState* row, int k, unsigned epoch,
                                             int lane) {
  for (int base = 0; base < k; base += 32) {
    const int j = k - 1 - base - lane;
    const TileState* p = row + (j < 0 ? 0 : j);
    for (;;) {
      const unsigned f = j < 0 ? epoch : load_acquire(&p->lit_flag);
      if (__all_sync(kAllLanes, f == epoch)) break;
    }
    const int lit = j < 0 ? -1 : static_cast<int>(__ldcg(&p->lit));
    const unsigned has = __ballot_sync(kAllLanes, lit >= 0);
    if (has) return __shfl_sync(kAllLanes, lit, __ffs(has) - 1);
  }
  return -1;
}

// The exclusive warp max-scan of the lanes' last literals mx, seeded with
// prev (the last before the step): the last literal before the lane's
// symbols; *step_last gets the last up to the step's end.
__device__ __forceinline__ int lit_before(int mx, int prev, int lane, int* step_last) {
  int m = mx;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kAllLanes, m, d);
    if (lane >= d && t > m) m = t;
  }
  const int last = __shfl_sync(kAllLanes, m, 31);
  *step_last = last > prev ? last : prev;
  int before = __shfl_up_sync(kAllLanes, m, 1);
  if (lane == 0) before = -1;
  return before > prev ? before : prev;
}

// K2's run table entry: code << 6 | escape << 5 | code length.  The run
// code of `run` from the entry of min(run, 255): its value, and its width
// in *n.
__device__ __forceinline__ uint32_t run_code(uint32_t e, int run, int* n) {
  const bool esc = e & 32u;
  *n = static_cast<int>(e & 31u) + (esc ? 16 : 0);
  return esc ? (e >> 6) << 16 | (static_cast<uint32_t>(run) & 0xFFFFu) : e >> 6;
}

constexpr int kWideLaneSyms = 16;                          // symbols per lane and step
constexpr int kWideStep = 32 * kWideLaneSyms;              // symbols per warp step
constexpr int kRunMinBlocks = 8;                           // blocks an SM holds, at least
constexpr int kRunWinWords = kWideStep * 56 / 32 + 2;      // <= 56 bits a literal

// A lane's 16 bytes from p[i0] on, four to a word, those from n on zero:
// one 16-byte load where aligned and whole, single bytes else.
__device__ __forceinline__ void lane_bytes16(const uint8_t* p, int i0, int n,
                                             uint32_t (&w)[4]) {
  if (i0 + kWideLaneSyms <= n && (reinterpret_cast<uintptr_t>(p + i0) & 15) == 0) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + i0);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
  for (int i = 0; i < kWideLaneSyms; ++i) {
    if (i0 + i < n) w[i >> 2] |= static_cast<uint32_t>(p[i0 + i]) << (8 * (i & 3));
  }
}

// The literals among a lane's 16 symbols from column i0 on (w: lane_bytes16)
// as a bit mask, bit i for column i0 + i: a symbol != rchar below hi.
__device__ __forceinline__ unsigned lit_mask(const uint32_t (&w)[4], int i0, int hi,
                                             int rchar) {
  unsigned m = 0xFFFFu;  // an rchar outside [0, 256) matches no symbol
  if (rchar >= 0 && rchar < 256) {
    const unsigned r4 = 0x01010101u * static_cast<unsigned>(rchar);
    m = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // one bit a byte that differs, gathered by a multiply
      m |= ((__vsetne4(w[j], r4) * 0x01020408u) >> 24 & 0xFu) << (4 * j);
    }
  }
  const int n = hi - i0;
  return n >= kWideLaneSyms ? m : (n > 0 ? m & ((1u << n) - 1u) : 0u);
}

// The symbol at column i0 + i of a lane's 16 (w: lane_bytes16).
__device__ __forceinline__ int sym_at(const uint32_t (&w)[4], int i) {
  const uint32_t x = i < 8 ? (i < 4 ? w[0] : w[1]) : (i < 12 ? w[2] : w[3]);
  return static_cast<int>((x >> (8 * (i & 3))) & 0xFFu);
}

// The last literal of a lane's mask from column i0 on, -1 if none.
__device__ __forceinline__ int last_lit(unsigned m, int i0) {
  return m ? i0 + 31 - __clz(m) : -1;
}

// A K2 literal at column col, after the literal at prev: its run code's
// table entry er and its symbol's entry es (K1's table).
struct LitCodes {
  uint32_t er, es;
  int run;
};

__device__ __forceinline__ LitCodes lit_codes(const uint32_t (&w)[4], int i, int col, int prev,
                                              const uint32_t* sym_t, const uint32_t* run_t) {
  const int run = col - prev - 1;
  return {run_t[run < 255 ? run : 255], sym_t[sym_at(w, i)], run};
}

// The bits of a lane's literals (mask m from column i0 on, the literal
// before them at prev).
__device__ __forceinline__ int lane_bits(const uint32_t (&w)[4], unsigned m, int i0, int prev,
                                         const uint32_t* sym_t, const uint32_t* run_t) {
  int tot = 0;
  for (; m; m &= m - 1) {
    const int i = __ffs(m) - 1;
    const LitCodes c = lit_codes(w, i, i0 + i, prev, sym_t, run_t);
    int rn;
    run_code(c.er, c.run, &rn);
    tot += rn + static_cast<int>(c.es & 31u);
    prev = i0 + i;
  }
  return tot;
}

__global__ void __launch_bounds__(32 * kPlainTileWarps, kRunMinBlocks)
encode_run_kernel(const uint8_t* __restrict__ data, const int* __restrict__ lengths,
                  const int* __restrict__ sym_luts, const int* __restrict__ run_luts,
                  const int* __restrict__ rchars, uint32_t* __restrict__ words,
                  int* __restrict__ t_out, int* __restrict__ lg_out, int n_rows,
                  long long width, long long mp, int tile_syms, int tiles_per_row,
                  long long n_tiles, unsigned epoch, TileState* __restrict__ states,
                  unsigned long long* __restrict__ counters) {
  __shared__ uint32_t s_sym[kPlainTileWarps][256];
  __shared__ uint32_t s_run[kPlainTileWarps][256];
  __shared__ uint32_t s_win[kPlainTileWarps][kRunWinWords];
  __shared__ long long s_ticket;

  if (threadIdx.x == 0) s_ticket = block_ticket(tiles_per_row, counters);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = s_ticket * kPlainTileWarps + warp;
  if (tile >= n_tiles) return;
  const long long r = tile / tiles_per_row;  // channel * n_rows + row
  const int k = static_cast<int>(tile - r * tiles_per_row);
  const int ch = static_cast<int>(r / n_rows);
  const int lo = k * tile_syms;
  // as K1's: the length, the first step and the tables load together
  const int len_in = lengths[r - static_cast<long long>(ch) * n_rows];
  const int rchar = rchars[ch];
  const uint8_t* row = data + r * width;
  const int lim = lo + tile_syms < width ? lo + tile_syms : static_cast<int>(width);
  uint32_t first[4];  // the tile's first step, for both passes
  lane_bytes16(row, lo + kWideLaneSyms * lane, lim, first);
  uint32_t* sym_t = s_sym[warp];
  uint32_t* run_t = s_run[warp];
  fill_table(sym_luts + ch * 256, sym_t, lane, [](int pk, int i) { return sym_entry(pk, i); });
  fill_table(run_luts + ch * 256, run_t, lane, [](int pk, int) {
    return (static_cast<uint32_t>(pk) >> 6) << 6 | (pk & 1) << 5 | ((pk >> 1) & 31);
  });
  const int len = clamp_len(len_in, width);
  if (k > 0 && lo >= len) return;
  const int hi = lo + tile_syms < len ? lo + tile_syms : len;
  const bool last_tile = hi == len;
  __syncwarp();

  Carry excl{0u, 0u};
  int excl_lit = -1;  // the row's last literal before the tile
  if (!last_tile || k > 0) {
    TileState* st = states + tile;
    if (!last_tile) {  // the tile's last literal, walking back from its end
      int tl = -1;
      for (int s0 = lo + (hi - lo - 1) / kWideStep * kWideStep; s0 >= lo && tl < 0;
           s0 -= kWideStep) {
        const int i0 = s0 + kWideLaneSyms * lane;
        uint32_t w[4];
        lane_bytes16(row, i0, hi, w);
        tl = __reduce_max_sync(kAllLanes, last_lit(lit_mask(w, i0, hi, rchar), i0));
      }
      if (lane == 0) publish_lit(st, tl, epoch);
    }
    if (k > 0) excl_lit = look_back_lit(states + (tile - k), k, epoch, lane);
    Carry a{0u, 0u};
    if (!last_tile) {  // the tile's (bit count, last <= 32 bits)
      int prev = excl_lit;
      uint32_t next[4] = {first[0], first[1], first[2], first[3]};
      for (int s0 = lo; s0 < hi; s0 += kWideStep) {
        const int i0 = s0 + kWideLaneSyms * lane;
        const uint32_t w[4] = {next[0], next[1], next[2], next[3]};
        if (s0 + kWideStep < hi) lane_bytes16(row, i0 + kWideStep, hi, next);
        const unsigned m = lit_mask(w, i0, hi, rchar);
        int step_last;
        int p = lit_before(last_lit(m, i0), prev, lane, &step_last);
        Carry sc{0u, 0u};
        for (unsigned mm = m; mm; mm &= mm - 1) {
          const int i = __ffs(mm) - 1;
          const LitCodes c = lit_codes(w, i, i0 + i, p, sym_t, run_t);
          int rn;
          const uint32_t rv = run_code(c.er, c.run, &rn);
          sc = combine(sc, Carry{static_cast<unsigned>(rn), rv});
          sc = combine(sc, Carry{c.es & 31u, c.es >> 6});
          p = i0 + i;
        }
        a = combine(a, warp_fold(sc, lane));
        prev = step_last;
      }
      if (lane == 0) publish(st, k > 0 ? kAgg : kInc, a, epoch);
    }
    if (k > 0) {
      excl = look_back(states + (tile - k), k, epoch, lane);
      if (!last_tile && lane == 0) publish(st, kInc, combine(excl, a), epoch);
    }
  }

  // the tile's bits, a warp step at a time, as K1's
  uint32_t* win = s_win[warp];
  uint32_t* dst = words + r * mp;
  unsigned bit = excl.n;
  uint32_t carry = bit & 31 ? excl.last << (32 - (bit & 31)) : 0u;
  int prev = excl_lit;
  uint32_t next[4] = {first[0], first[1], first[2], first[3]};  // loaded a step ahead
  for (int s0 = lo; s0 < hi; s0 += kWideStep) {
    const int i0 = s0 + kWideLaneSyms * lane;
    const uint32_t w[4] = {next[0], next[1], next[2], next[3]};
    if (s0 + kWideStep < hi) lane_bytes16(row, i0 + kWideStep, hi, next);
    const unsigned m = lit_mask(w, i0, hi, rchar);
    int step_last;
    const int p = lit_before(last_lit(m, i0), prev, lane, &step_last);
    const int tot = lane_bits(w, m, i0, p, sym_t, run_t);
    int inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kAllLanes, inc, d);
      if (lane >= d) inc += t;
    }
    const int step_bits = __shfl_sync(kAllLanes, inc, 31);
    const int o = static_cast<int>(bit & 31);
    const int n_win = (o + step_bits + 31) >> 5;
    for (int i = lane; i < n_win; i += 32) win[i] = i == 0 ? carry : 0u;
    __syncwarp();
    {
      // K1's accumulator: the first b & 31 bits zeros for the lanes before
      const int b = o + inc - tot;
      int wi = b >> 5, ab = b & 31;
      unsigned long long acc = 0ull;
      int q = p;
      for (unsigned mm = m; mm; mm &= mm - 1) {
        const int i = __ffs(mm) - 1;
        const LitCodes c = lit_codes(w, i, i0 + i, q, sym_t, run_t);
        int rn;
        const uint32_t rv = run_code(c.er, c.run, &rn);
        acc = (acc << rn) | rv;
        ab += rn;
        if (ab >= 32) {
          ab -= 32;
          atomicOr(&win[wi], static_cast<uint32_t>(acc >> ab));
          ++wi;
        }
        const int sn = static_cast<int>(c.es & 31u);
        acc = (acc << sn) | (c.es >> 6);
        ab += sn;
        if (ab >= 32) {
          ab -= 32;
          atomicOr(&win[wi], static_cast<uint32_t>(acc >> ab));
          ++wi;
        }
        q = i0 + i;
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
    prev = step_last;
  }
  if (last_tile && lane == 0) {
    const int trail = len - prev - 1;  // the run after the row's last literal
    int tn = 0, lg = 0;
    uint32_t tv = 0u;
    if (trail > 0) {
      const uint32_t e = run_t[trail < 255 ? trail : 255];
      tv = run_code(e, trail, &tn);
      lg = e & 32u ? 16 : static_cast<int>(e & 31u);
    } else if (len > 0) {  // the row ends in a literal
      const uint32_t e = sym_t[row[len - 1]];
      lg = e & 32u ? 8 : static_cast<int>(e & 31u);
    }
    const int o = static_cast<int>(bit & 31);
    const unsigned long long x = static_cast<unsigned long long>(carry) << 32 |
                                 (tn ? static_cast<unsigned long long>(tv) << (64 - o - tn) : 0ull);
    uint32_t* d = dst + (bit >> 5);
    if (o + tn > 0) d[0] = static_cast<uint32_t>(x >> 32);
    if (o + tn > 32) d[1] = static_cast<uint32_t>(x);
    t_out[r] = static_cast<int>(bit) + tn;
    lg_out[r] = lg;
  }
}

// K3: K1's warps over tiles of a row, for the delTag's bases (Pack_Tag +
// Number_Read + Compress_Read, QV.c:810-819).  A tag is kept where its delQV
// byte != del_char (every tag inside the row's length when del_char < 0); its
// 2-bit code number_lut[tag] goes to the row's packed bytes at rank >> 2, the
// first code of a byte in bits 7-6 (DB.c:334), rank its index among the row's
// kept tags.  The prologue is K1's.  A lane takes 16 (tag, delQV) pairs a step
// (two 16-byte loads where the row allows, loaded a step ahead); its kept
// codes form one <= 32-bit value; a shuffle scan of the lanes' counts gives
// each lane its rank, and the lane ORs its bits into a per-warp window of
// big-endian words at bit 2 * rank, touching at most two words.  A finished
// word is four packed bytes: one byte-swapped 32-bit store where the row
// starts 4-byte aligned, four byte stores where it does not (a width that is
// no multiple of 4).  The tiles chain by K8's look-back over (2 * kept, last
// <= 32 bits), which depends on the tile alone.  The row's last tile also
// stores the partial last word's bytes, clens and the zeros up to wbytes
// (16-byte stores where aligned).
constexpr int kTagWinWords = kWideStep * 2 / 32 + 2;       // 2 bits a tag

// A lane's 16 tags and delQV bytes from column i0 on (lane_bytes16).
struct TagBytes {
  uint32_t t[4], d[4];
};

__device__ __forceinline__ void load_tags(const uint8_t* tg, const uint8_t* dl, int i0, int n,
                                          TagBytes* b) {
  lane_bytes16(tg, i0, n, b->t);
  lane_bytes16(dl, i0, n, b->d);
}

// The kept tags among a lane's 16 from column i0 on, below n: their codes
// right-aligned in column order, and their count in *cnt.
__device__ __forceinline__ uint32_t lane_tags(const TagBytes& b, const uint32_t* lut,
                                              int del_char, int i0, int n, int* cnt) {
  uint32_t v = 0u;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kWideLaneSyms; ++i) {
    const int dv = (b.d[i >> 2] >> (8 * (i & 3))) & 0xFF;
    const bool keep = i0 + i < n && (del_char < 0 || dv != del_char);
    const uint32_t code = lut[(b.t[i >> 2] >> (8 * (i & 3))) & 0xFF];
    v = keep ? (v << 2) | code : v;
    c += keep;
  }
  *cnt = c;
  return v;
}

// Bytes [b0, end) of a row: the big-endian word `word`'s bytes, then zeros.
__device__ __forceinline__ void store_tail(uint8_t* dst, long long b0, long long end,
                                           uint32_t word, int lane) {
  if (lane < 4 && b0 + lane < end) dst[b0 + lane] = static_cast<uint8_t>(word >> (24 - 8 * lane));
  const long long z0 = b0 + 4;
  if (z0 >= end) return;
  uint8_t* p = dst + z0;
  const long long n = end - z0;
  long long head = (16 - static_cast<long long>(reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  if (head > n) head = n;
  if (lane < head) p[lane] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  const long long nq = (n - head) >> 4;
  for (long long i = lane; i < nq; i += 32) q[i] = make_uint4(0u, 0u, 0u, 0u);
  const long long done = head + (nq << 4);
  if (lane < n - done) p[done + lane] = 0;
}

__global__ void __launch_bounds__(32 * kPlainTileWarps, kPlainMinBlocks)
pack_tags_kernel(const uint8_t* __restrict__ tags, const uint8_t* __restrict__ dels,
                 const int* __restrict__ lengths, const int* __restrict__ del_char_p,
                 const uint8_t* __restrict__ number_lut, uint8_t* __restrict__ packed,
                 int* __restrict__ clens, long long width, long long wbytes, int tile_syms,
                 int tiles_per_row, long long n_tiles, unsigned epoch,
                 TileState* __restrict__ states, unsigned long long* __restrict__ counters) {
  __shared__ uint32_t s_lut[kPlainTileWarps][256];
  __shared__ uint32_t s_win[kPlainTileWarps][kTagWinWords];
  __shared__ long long s_ticket;

  if (threadIdx.x == 0) s_ticket = block_ticket(tiles_per_row, counters);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = s_ticket * kPlainTileWarps + warp;
  if (tile >= n_tiles) return;
  const long long row = tile / tiles_per_row;
  const int k = static_cast<int>(tile - row * tiles_per_row);
  const int lo = k * tile_syms;
  // as K1's: the length, the first step and the table load together
  const int len_in = lengths[row];
  const int del_char = *del_char_p;
  const uint8_t* tg = tags + row * width;
  const uint8_t* dl = dels + row * width;
  const int lim = lo + tile_syms < width ? lo + tile_syms : static_cast<int>(width);
  TagBytes first;  // the tile's first step, for both passes
  load_tags(tg, dl, lo + kWideLaneSyms * lane, lim, &first);
  uint32_t* lut = s_lut[warp];
  fill_table(number_lut, lut, lane, [](uint8_t c, int) { return c & 3u; });
  const int len = clamp_len(len_in, width);
  if (k > 0 && lo >= len) return;
  const int hi = lo + tile_syms < len ? lo + tile_syms : len;
  const bool last_tile = hi == len;
  __syncwarp();

  Carry excl{0u, 0u};
  if (!last_tile || k > 0) {
    TileState* st = states + tile;
    Carry a{0u, 0u};
    if (!last_tile) {  // the tile's (2 * kept, last <= 32 bits)
      TagBytes next = first;
      for (int s0 = lo; s0 < hi; s0 += kWideStep) {
        const int i0 = s0 + kWideLaneSyms * lane;
        const TagBytes b = next;
        if (s0 + kWideStep < hi) load_tags(tg, dl, i0 + kWideStep, hi, &next);
        int cnt;
        const uint32_t v = lane_tags(b, lut, del_char, i0, hi, &cnt);
        a = combine(a, warp_fold(Carry{2u * cnt, v}, lane));
      }
      if (lane == 0) publish(st, k > 0 ? kAgg : kInc, a, epoch);
    }
    if (k > 0) {
      excl = look_back(states + (tile - k), k, epoch, lane);
      if (!last_tile && lane == 0) publish(st, kInc, combine(excl, a), epoch);
    }
  }

  // the tile's bits, a warp step at a time: the window holds the row's
  // big-endian words from word bit >> 5 on, word 0 with the bits carried
  uint32_t* win = s_win[warp];
  uint8_t* dst = packed + row * wbytes;
  const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 3) == 0;
  unsigned bit = excl.n;
  uint32_t carry = bit & 31 ? excl.last << (32 - (bit & 31)) : 0u;
  TagBytes next = first;  // the next step's bytes, loaded a step ahead
  for (int s0 = lo; s0 < hi; s0 += kWideStep) {
    const int i0 = s0 + kWideLaneSyms * lane;
    const TagBytes b = next;
    if (s0 + kWideStep < hi) load_tags(tg, dl, i0 + kWideStep, hi, &next);
    int cnt;
    const uint32_t v = lane_tags(b, lut, del_char, i0, hi, &cnt);
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kAllLanes, inc, d);
      if (lane >= d) inc += t;
    }
    const int step_bits = 2 * __shfl_sync(kAllLanes, inc, 31);
    const int o = static_cast<int>(bit & 31);
    const int n_win = (o + step_bits + 31) >> 5;
    for (int i = lane; i < n_win; i += 32) win[i] = i == 0 ? carry : 0u;
    __syncwarp();
    if (cnt) {
      const int p = o + 2 * (inc - cnt);
      const uint32_t lv = v << (32 - 2 * cnt);  // the lane's bits, left-aligned
      atomicOr(&win[p >> 5], lv >> (p & 31));
      if ((p & 31) + 2 * cnt > 32) atomicOr(&win[(p >> 5) + 1], lv << (32 - (p & 31)));
    }
    __syncwarp();
    const int full = (o + step_bits) >> 5;
    const long long w0 = bit >> 5;
    for (int i = lane; i < full; i += 32) {
      const uint32_t x = win[i];
      if (aligned) {
        reinterpret_cast<uint32_t*>(dst)[w0 + i] = __byte_perm(x, 0u, 0x0123);
      } else {
        uint8_t* q = dst + 4 * (w0 + i);
        q[0] = static_cast<uint8_t>(x >> 24);
        q[1] = static_cast<uint8_t>(x >> 16);
        q[2] = static_cast<uint8_t>(x >> 8);
        q[3] = static_cast<uint8_t>(x);
      }
    }
    carry = full < n_win ? win[full] : 0u;
    __syncwarp();
    bit += step_bits;
  }
  if (last_tile) {
    if (lane == 0) clens[row] = static_cast<int>(bit >> 1);
    store_tail(dst, 4LL * (bit >> 5), wbytes, bit & 31 ? carry : 0u, lane);
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

// K9: up to kLutGroups lookups in one launch.  Group g is
// out_g[i] = luts[lut_g][data_g[i] & 255] over its count_g elements.
constexpr int kLutGroups = 8;
constexpr int kLutQuads = 4;                          // 4-element quads a thread
constexpr int kLutTile = 4 * kLutQuads * kThreads;    // elements a block: 4,096

struct LutGroup {
  const void* data;
  int* out;
  long long count;
  int is_u8;
  int vec;     // data and out aligned for 4-element loads and 16-byte stores
  int lut;     // row of the (G, 256) tables
};

struct LutGroups {             // passed by value: the kernel's parameters
  LutGroup g[kLutGroups];
  long long first[kLutGroups + 1];   // the groups' first blocks: exclusive prefix of their tiles
  int n;
};

// One tile of a group, elements [lo, hi) with lo a multiple of kLutTile.  A
// whole aligned tile: each thread loads its four quads first (a warp's load
// is 128 contiguous bytes of u8 or 512 of int32), then stores them as four
// 16-byte stores (512 contiguous bytes a warp); the tail tile, or a group
// that is not aligned, one element a thread and step.
template <typename T>
__device__ __forceinline__ void lut_tile(const T* __restrict__ data, int* __restrict__ out,
                                         long long lo, long long hi, bool vec,
                                         const int* s_lut) {
  if (vec && hi - lo == kLutTile) {
    const long long q0 = (lo >> 2) + threadIdx.x;
    int d[kLutQuads][4];
#pragma unroll
    for (int k = 0; k < kLutQuads; ++k) load4(data, q0 + k * kThreads, d[k]);
#pragma unroll
    for (int k = 0; k < kLutQuads; ++k) {
      reinterpret_cast<int4*>(out)[q0 + k * kThreads] =
          make_int4(s_lut[d[k][0] & 255], s_lut[d[k][1] & 255], s_lut[d[k][2] & 255],
                    s_lut[d[k][3] & 255]);
    }
    return;
  }
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    out[i] = s_lut[static_cast<int>(data[i]) & 255];
  }
}

// One block a tile of one group: block b belongs to the group g with
// first[g] <= b < first[g + 1] (a group of 0 elements has no tile), and
// stages only that group's 1 KB table in shared memory.
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const LutGroups gs, const int* __restrict__ luts) {
  __shared__ int s_lut[256];
  const long long b = blockIdx.x;
  int g = 0;
  while (g + 1 < gs.n && gs.first[g + 1] <= b) ++g;
  const LutGroup& grp = gs.g[g];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_lut[i] = luts[grp.lut * 256 + i];
  __syncthreads();
  const long long lo = (b - gs.first[g]) * kLutTile;
  const long long hi = lo + kLutTile < grp.count ? lo + kLutTile : grp.count;
  if (grp.is_u8) {
    lut_tile(static_cast<const uint8_t*>(grp.data), grp.out, lo, hi, grp.vec, s_lut);
  } else {
    lut_tile(static_cast<const int*>(grp.data), grp.out, lo, hi, grp.vec, s_lut);
  }
}

// The tiles of a launch of K1, K2 or K3 over `rows` rows of `width`
// symbols walked in warp steps of `step`: the tile is the row's width in
// whole steps, at most kPlainTileMax symbols, halved (to whole steps,
// kPlainTileMin at least) while the launch has fewer than kPlainMinTiles
// tiles; a row of one tile takes no ticket and no look-back, and a bucket
// of few wide rows is cut finer.  Blocks of kPlainTileWarps tiles.
struct TileLaunch {
  long long tile, per_row, tiles, blocks;
};

TileLaunch tile_launch(long long rows, long long width, long long step) {
  auto steps = [step](long long n) { return (n + step - 1) / step * step; };
  long long tile = steps(width > 0 ? width : 1);
  if (tile > kPlainTileMax) tile = kPlainTileMax;
  auto per_row = [&](long long ts) { return width > 0 ? (width + ts - 1) / ts : 1LL; };
  while (tile > kPlainTileMin && rows * per_row(tile) < kPlainMinTiles) {
    const long long half = steps(tile / 2);
    tile = half < kPlainTileMin ? kPlainTileMin : half;
  }
  const long long tiles = rows * per_row(tile);
  return {tile, per_row(tile), tiles, (tiles + kPlainTileWarps - 1) / kPlainTileWarps};
}

bool launch_ok(const TileLaunch& t, unsigned epoch) {
  return t.blocks <= 0x7fffffffLL && epoch != 0 && epoch < (1u << 30);
}

}  // namespace

// Plain C entry points, loaded with ctypes (ops/_build.py).  Each launches on
// the given stream, never synchronises, and returns cudaGetLastError().
//
// K1, K2 and K3 take scratch and epoch as dxt_pack_words does (K1-K3 and K8
// share them), with rows * max(1, ceil(width / 512)) tile states, rows the
// launch's (channel, row) pairs: enough for any tile of at least
// kPlainTileMin symbols (tile_launch).

extern "C" int dxt_encode_plain(const void* data, const void* lengths, const void* luts,
                                void* words, void* t, void* lg, int channels, int n_rows,
                                long long width, long long mp, void* scratch, unsigned epoch,
                                void* stream) {
  if (channels <= 0 || n_rows <= 0) return 0;
  const TileLaunch tl = tile_launch(static_cast<long long>(channels) * n_rows, width, kPlainStep);
  if (!launch_ok(tl, epoch)) return static_cast<int>(cudaErrorInvalidValue);
  auto* counters = static_cast<unsigned long long*>(scratch);
  encode_plain_kernel<<<static_cast<unsigned>(tl.blocks), 32 * kPlainTileWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths),
      static_cast<const int*>(luts), static_cast<uint32_t*>(words), static_cast<int*>(t),
      static_cast<int*>(lg), n_rows, width, mp, static_cast<int>(tl.tile),
      static_cast<int>(tl.per_row), tl.tiles, epoch,
      reinterpret_cast<TileState*>(counters + 2), counters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dxt_encode_run(const void* data, const void* lengths, const void* sym_luts,
                              const void* run_luts, const void* rchars, void* words, void* t,
                              void* lg, int channels, int n_rows, long long width,
                              long long mp, void* scratch, unsigned epoch, void* stream) {
  if (channels <= 0 || n_rows <= 0) return 0;
  const TileLaunch tl = tile_launch(static_cast<long long>(channels) * n_rows, width, kWideStep);
  if (!launch_ok(tl, epoch)) return static_cast<int>(cudaErrorInvalidValue);
  auto* counters = static_cast<unsigned long long*>(scratch);
  encode_run_kernel<<<static_cast<unsigned>(tl.blocks), 32 * kPlainTileWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int*>(lengths),
      static_cast<const int*>(sym_luts), static_cast<const int*>(run_luts),
      static_cast<const int*>(rchars), static_cast<uint32_t*>(words), static_cast<int*>(t),
      static_cast<int*>(lg), n_rows, width, mp, static_cast<int>(tl.tile),
      static_cast<int>(tl.per_row), tl.tiles, epoch,
      reinterpret_cast<TileState*>(counters + 2), counters);
  return static_cast<int>(cudaGetLastError());
}

// del_char: a device int (-1: keep every tag); packed: (n_rows, wbytes) bytes.
extern "C" int dxt_pack_tags(const void* tags, const void* dels, const void* lengths,
                             const void* del_char, const void* number_lut, void* packed,
                             void* clens, int n_rows, long long width, long long wbytes,
                             void* scratch, unsigned epoch, void* stream) {
  if (n_rows <= 0) return 0;
  const TileLaunch tl = tile_launch(n_rows, width, kWideStep);
  if (!launch_ok(tl, epoch)) return static_cast<int>(cudaErrorInvalidValue);
  auto* counters = static_cast<unsigned long long*>(scratch);
  pack_tags_kernel<<<static_cast<unsigned>(tl.blocks), 32 * kPlainTileWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tags), static_cast<const uint8_t*>(dels),
      static_cast<const int*>(lengths), static_cast<const int*>(del_char),
      static_cast<const uint8_t*>(number_lut), static_cast<uint8_t*>(packed),
      static_cast<int*>(clens), width, wbytes, static_cast<int>(tl.tile),
      static_cast<int>(tl.per_row), tl.tiles, epoch,
      reinterpret_cast<TileState*>(counters + 2), counters);
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

// desc: n_groups (at most kLutGroups) records of five long longs, (data
// pointer, 1 if data is uint8 else 0 for int32, row of luts, out pointer,
// count); luts: (G, 256) int32.  One launch, the tiles of every group.
extern "C" int dxt_lut_gather(int n_groups, const long long* desc, const void* luts,
                              void* stream) {
  if (n_groups <= 0 || n_groups > kLutGroups) return static_cast<int>(cudaErrorInvalidValue);
  LutGroups gs{};
  long long tiles = 0;
  for (int g = 0; g < n_groups; ++g) {
    const long long* d = desc + 5 * g;
    LutGroup& grp = gs.g[g];
    grp.data = reinterpret_cast<const void*>(d[0]);
    grp.is_u8 = d[1] != 0;
    grp.lut = static_cast<int>(d[2]);
    grp.out = reinterpret_cast<int*>(d[3]);
    grp.count = d[4] > 0 ? d[4] : 0;
    grp.vec = static_cast<uint64_t>(d[0]) % (grp.is_u8 ? 4 : 16) == 0 &&
              static_cast<uint64_t>(d[3]) % 16 == 0;
    gs.first[g] = tiles;
    tiles += (grp.count + kLutTile - 1) / kLutTile;
  }
  gs.first[n_groups] = tiles;
  gs.n = n_groups;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lut_gather_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(gs, static_cast<const int*>(luts));
  return static_cast<int>(cudaGetLastError());
}
