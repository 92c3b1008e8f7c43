/* Host-side Huffman channel encoder (CPU fallback for the TPU pipeline).
 *
 * Replicates the reference's 32-bit OCODE emitter byte for byte
 * (QV.c:404-506) including the tail-padding rule, the escape literal
 * (8-bit value / 16-bit run length), and the unconditional run-escape
 * test against symbol 255's code.  All entries of one channel are encoded
 * in a single call over concatenated streams.
 *
 * Build: gcc -O2 -shared -fPIC qv_encode.c -o _qv_encode.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct
  { uint8_t  *out;
    int64_t   cap;
    int64_t   len;
    uint32_t  accum;      /* bits not yet written, MSB-justified */
    int       fill;       /* occupied bits of accum */
    int       prev_fill;  /* fill before the last emit (tail rule) */
  } Emit;

static inline int put_word(Emit *e, uint32_t w)
{ if (e->len + 4 > e->cap)
    return -1;
  memcpy(e->out + e->len, &w, 4);     /* little-endian host */
  e->len += 4;
  return 0;
}

static inline int emit_bits(Emit *e, uint32_t code, int len)
{ int t = e->fill + len;
  e->prev_fill = e->fill;
  if (t >= 32)
    { e->fill = t - 32;
      e->accum |= (e->fill ? (code >> e->fill) : code);
      if (put_word(e, e->accum) < 0)
        return -1;
      e->accum = e->fill ? (code << (32 - e->fill)) : 0;
    }
  else
    { e->fill = t;
      e->accum |= code << (32 - t);
    }
  return 0;
}

static inline int flush_tail(Emit *e)
{ if (e->fill > 0)
    { if (put_word(e, e->accum) < 0)
        return -1;
      if (e->prev_fill > 16 && e->fill > e->prev_fill)
        if (put_word(e, e->accum) < 0)
          return -1;
    }
  else if (e->prev_fill > 16)
    if (put_word(e, e->accum) < 0)
      return -1;
  e->accum = 0;
  e->fill = 0;
  e->prev_fill = 0;
  return 0;
}

/* Exact per-symbol plain encoder: one emit_bits per code plus the 8-bit
 * escape literal (QV.c:404-442 semantics).  The fast path's correctness
 * reference AND its fallback (table alloc failure, or code lengths the
 * packed tables cannot carry). */
static long long encode_plain_scalar(
    const uint8_t *data, const int64_t *offs, long long n_entries,
    const uint32_t *bits, const int32_t *lens,
    uint32_t esc_code, int esc_len,
    uint8_t *out, long long cap, int64_t *out_lens)
{ Emit    e = { out, cap, 0, 0, 0, 0 };
  int64_t i, k, before;

  for (i = 0; i < n_entries; i++)
    { before = e.len;
      for (k = offs[i]; k < offs[i + 1]; k++)
        { uint8_t  x = data[k];
          uint32_t c = bits[x];
          int      n = lens[x];
          if (emit_bits(&e, c, n) < 0)
            return -1;
          if (c == esc_code && n == esc_len)
            if (emit_bits(&e, x, 8) < 0)
              return -1;
        }
      if (flush_tail(&e) < 0)
        return -1;
      out_lens[i] = e.len - before;
    }
  return e.len;
}

/* Encode n_entries plain streams (concatenated in data with offs[n+1]).
 * Returns total bytes or -1 on cap overflow.  out_lens: bytes per entry.
 *
 * Fast path: per-symbol "effective" codes fold the type-2 escape literal
 * into a single <=32-bit emission (code<<8 | value), and a 64K pair table
 * pre-concatenates two effective codes (<=64 bits) so the body of every
 * entry costs one table load and one 128-bit shift-or per symbol pair —
 * the QV alphabet is skewed, so the table's hot rows stay cached.  Only
 * the LAST emission of each entry goes through the exact scalar emitter,
 * which is what keeps prev_fill (the duplicate-word tail-padding rule,
 * QV.c:436-442) byte-identical to the reference.
 *
 * Codes longer than 24 bits would overflow the folded escape emission
 * (esc_code<<8 must fit uint32); self-built schemes stay <= HUFF_CUTOFF
 * = 16, but a foreign scheme routes through the exact scalar encoder —
 * as does pair-table allocation failure (rather than misreporting it as
 * an output-buffer overflow). */
long long dxt_encode_plain(
    const uint8_t *data, const int64_t *offs, long long n_entries,
    const uint32_t *bits, const int32_t *lens, int type,
    uint8_t *out, long long cap, int64_t *out_lens)
{ Emit     e = { out, cap, 0, 0, 0, 0 };
  uint32_t esc_code = type == 2 ? bits[255] : 0xffffffffu;
  int      esc_len = type == 2 ? lens[255] : -1;
  int64_t  i, before;
  uint32_t eff_bits[256];
  uint8_t  eff_len[256];
  uint64_t *pair_bits;
  uint8_t  *pair_len;
  int      s1, s2;

  for (s1 = 0; s1 < 256; s1++)
    if (lens[s1] > 24)
      return encode_plain_scalar(data, offs, n_entries, bits, lens,
                                 esc_code, esc_len, out, cap, out_lens);
  for (s1 = 0; s1 < 256; s1++)
    { if (bits[s1] == esc_code && lens[s1] == esc_len)
        { eff_bits[s1] = (esc_code << 8) | (uint32_t) s1;
          eff_len[s1] = (uint8_t) (esc_len + 8);
        }
      else
        { eff_bits[s1] = bits[s1];
          eff_len[s1] = (uint8_t) lens[s1];
        }
    }
  pair_bits = (uint64_t *) malloc((size_t) 65536 * sizeof(uint64_t));
  pair_len = (uint8_t *) malloc(65536);
  if (pair_bits == NULL || pair_len == NULL)
    { free(pair_bits);
      free(pair_len);
      return encode_plain_scalar(data, offs, n_entries, bits, lens,
                                 esc_code, esc_len, out, cap, out_lens);
    }
  for (s1 = 0; s1 < 256; s1++)
    { uint64_t b1 = eff_bits[s1];
      int      l1 = eff_len[s1];
      uint64_t *row = pair_bits + ((size_t) s1 << 8);
      uint8_t  *rl = pair_len + ((size_t) s1 << 8);
      for (s2 = 0; s2 < 256; s2++)
        { row[s2] = (b1 << eff_len[s2]) | eff_bits[s2];
          rl[s2] = (uint8_t) (l1 + eff_len[s2]);
        }
    }

  for (i = 0; i < n_entries; i++)
    { const uint8_t *s = data + offs[i];
      int64_t        L = offs[i + 1] - offs[i];
      before = e.len;
      if (L > 1)
        { int64_t            body = L - 1, j = 0;
          unsigned __int128  acc = ((unsigned __int128) e.accum) << 96;
          int                fill = e.fill;
          for (; j + 1 < body; j += 2)
            { uint32_t idx = ((uint32_t) s[j] << 8) | s[j + 1];
              int      pl = pair_len[idx];
              if (pl)
                acc |= ((unsigned __int128) pair_bits[idx])
                       << (128 - fill - pl);
              fill += pl;
              while (fill >= 32)
                { if (put_word(&e, (uint32_t) (acc >> 96)) < 0)
                    goto fail;
                  acc <<= 32;
                  fill -= 32;
                }
            }
          if (j < body)
            { uint32_t x = s[j];
              int      el = eff_len[x];
              if (el)
                acc |= ((unsigned __int128) eff_bits[x])
                       << (128 - fill - el);
              fill += el;
              while (fill >= 32)
                { if (put_word(&e, (uint32_t) (acc >> 96)) < 0)
                    goto fail;
                  acc <<= 32;
                  fill -= 32;
                }
            }
          e.accum = (uint32_t) (acc >> 96);
          e.fill = fill;
        }
      if (L > 0)
        { uint8_t  x = s[L - 1];
          uint32_t c = bits[x];
          int      n = lens[x];
          if (emit_bits(&e, c, n) < 0)
            goto fail;
          if (c == esc_code && n == esc_len)
            if (emit_bits(&e, x, 8) < 0)
              goto fail;
        }
      if (flush_tail(&e) < 0)
        goto fail;
      out_lens[i] = e.len - before;
    }
  free(pair_bits);
  free(pair_len);
  return e.len;

fail:
  free(pair_bits);
  free(pair_len);
  return -1;
}

/* First index >= k in [k, end) whose byte differs from rc — SWAR 8 bytes
 * at a time (delChar-heavy streams have long runs; the ctz of the XORed
 * word names the first mismatching byte on a little-endian host, which
 * put_word already assumes). */
static inline int64_t scan_run(const uint8_t *d, int64_t k, int64_t end,
                               uint8_t rc)
{ uint64_t pat = 0x0101010101010101ull * rc;
  if (k < end && d[k] != rc)
    return k;
  while (k + 8 <= end)
    { uint64_t v;
      memcpy(&v, d + k, 8);
      v ^= pat;
      if (v)
        return k + (__builtin_ctzll(v) >> 3);
      k += 8;
    }
  while (k < end && d[k] == rc)
    k += 1;
  return k;
}

/* Exact per-token run encoder (Encode_Run semantics, QV.c:446-506): runs
 * of rchar alternate with single literals; run buckets sharing symbol
 * 255's code append the 16-bit true length.  The fast path's correctness
 * reference and fallback. */
static long long encode_run_scalar(
    const uint8_t *data, const int64_t *offs, long long n_entries,
    const uint32_t *nbits, const int32_t *nlens,
    uint32_t esc_code, int esc_len,
    const uint32_t *rbits, const int32_t *rlens, int rchar,
    uint8_t *out, long long cap, int64_t *out_lens)
{ Emit     e = { out, cap, 0, 0, 0, 0 };
  uint32_t run_esc_code = rbits[255];
  int      run_esc_len = rlens[255];
  int64_t  i, before;

  for (i = 0; i < n_entries; i++)
    { int64_t k = offs[i], end = offs[i + 1];
      before = e.len;
      while (k < end)
        { int64_t  h = k;
          uint32_t c;
          int      n, x;
          k = scan_run(data, k, end, (uint8_t) rchar);
          x = (k - h >= 255) ? 255 : (int) (k - h);
          c = rbits[x];
          n = rlens[x];
          if (emit_bits(&e, c, n) < 0)
            return -1;
          if (c == run_esc_code && n == run_esc_len)
            if (emit_bits(&e, (uint32_t) ((k - h) & 0xffff), 16) < 0)
              return -1;
          if (k < end)
            { uint8_t s = data[k];
              c = nbits[s];
              n = nlens[s];
              if (emit_bits(&e, c, n) < 0)
                return -1;
              if (c == esc_code && n == esc_len)
                if (emit_bits(&e, s, 8) < 0)
                  return -1;
              k += 1;
            }
        }
      if (flush_tail(&e) < 0)
        return -1;
      out_lens[i] = e.len - before;
    }
  return e.len;
}

/* RLE channel encoder with the pair-table fast path: each (run bucket x,
 * literal s) pair folds the run code, its 16-bit shared-escape length
 * literal (= x when x < 255), the literal code and its 8-bit escape
 * literal into ONE <=56-bit table emission through the u128 accumulator
 * — the same scheme the plain encoder uses, with the run bucket taking
 * the place of the first symbol.  Runs >= 255 chars (bucket 255 carries
 * a dynamic 16-bit length) stay scalar-composed but still ride the u128
 * accumulator; the LAST emission group of each entry goes through the
 * exact emit_bits path so prev_fill keeps the duplicate-word tail rule
 * byte-identical (QV.c:499-505).
 *
 * Fast-path bound: run code <= 16 bits (+16 literal) and literal code
 * <= 16 (+8) keep every pair <= 56 bits; schemes beyond HUFF_CUTOFF=16
 * (foreign files) and table-allocation failure route through the exact
 * scalar encoder. */
long long dxt_encode_run(
    const uint8_t *data, const int64_t *offs, long long n_entries,
    const uint32_t *nbits, const int32_t *nlens, int ntype,
    const uint32_t *rbits, const int32_t *rlens, int rchar,
    uint8_t *out, long long cap, int64_t *out_lens)
{ Emit     e = { out, cap, 0, 0, 0, 0 };
  uint32_t esc_code = ntype == 2 ? nbits[255] : 0xffffffffu;
  int      esc_len = ntype == 2 ? nlens[255] : -1;
  uint32_t run_esc_code = rbits[255];
  int      run_esc_len = rlens[255];
  int64_t  i, before;
  uint32_t lit_bits[256], run_bits_eff[256];
  uint8_t  lit_len[256], run_len_eff[256];
  uint64_t *pair_bits;
  uint8_t  *pair_len;
  int      s1, s2;

  for (s1 = 0; s1 < 256; s1++)
    if (nlens[s1] > 16 || rlens[s1] > 16)
      return encode_run_scalar(data, offs, n_entries, nbits, nlens,
                               esc_code, esc_len, rbits, rlens, rchar,
                               out, cap, out_lens);
  for (s1 = 0; s1 < 256; s1++)
    { if (nbits[s1] == esc_code && nlens[s1] == esc_len)
        { lit_bits[s1] = (esc_code << 8) | (uint32_t) s1;
          lit_len[s1] = (uint8_t) (esc_len + 8);
        }
      else
        { lit_bits[s1] = nbits[s1];
          lit_len[s1] = (uint8_t) nlens[s1];
        }
      if (rbits[s1] == run_esc_code && rlens[s1] == run_esc_len)
        { run_bits_eff[s1] = (run_esc_code << 16) | (uint32_t) s1;
          run_len_eff[s1] = (uint8_t) (run_esc_len + 16);
        }
      else
        { run_bits_eff[s1] = rbits[s1];
          run_len_eff[s1] = (uint8_t) rlens[s1];
        }
    }
  pair_bits = (uint64_t *) malloc((size_t) 65536 * sizeof(uint64_t));
  pair_len = (uint8_t *) malloc(65536);
  if (pair_bits == NULL || pair_len == NULL)
    { free(pair_bits);
      free(pair_len);
      return encode_run_scalar(data, offs, n_entries, nbits, nlens,
                               esc_code, esc_len, rbits, rlens, rchar,
                               out, cap, out_lens);
    }
  for (s1 = 0; s1 < 256; s1++)
    { uint64_t b1 = run_bits_eff[s1];
      int      l1 = run_len_eff[s1];
      uint64_t *row = pair_bits + ((size_t) s1 << 8);
      uint8_t  *rl = pair_len + ((size_t) s1 << 8);
      for (s2 = 0; s2 < 256; s2++)
        { row[s2] = (b1 << lit_len[s2]) | lit_bits[s2];
          rl[s2] = (uint8_t) (l1 + lit_len[s2]);
        }
    }

  for (i = 0; i < n_entries; i++)
    { int64_t            k = offs[i], end = offs[i + 1];
      unsigned __int128  acc = 0;
      int                fill = 0;
      before = e.len;
      while (k < end)
        { int64_t h = k;
          int64_t run;
          int     x;
          k = scan_run(data, k, end, (uint8_t) rchar);
          run = k - h;
          x = (run >= 255) ? 255 : (int) run;
          if (k + 1 < end)
            { /* interior (run, literal) pair */
              uint8_t s = data[k];
              k += 1;
              if (x < 255)
                { uint32_t idx = ((uint32_t) x << 8) | s;
                  int      pl = pair_len[idx];
                  acc |= ((unsigned __int128) pair_bits[idx])
                         << (128 - fill - pl);
                  fill += pl;
                }
              else
                { /* dynamic 16-bit length, then the literal */
                  uint64_t rb = ((uint64_t) run_esc_code << 16)
                              | (uint32_t) (run & 0xffff);
                  int      rn = run_esc_len + 16;
                  acc |= ((unsigned __int128) rb) << (128 - fill - rn);
                  fill += rn;
                  acc |= ((unsigned __int128) lit_bits[s])
                         << (128 - fill - lit_len[s]);
                  fill += lit_len[s];
                }
              while (fill >= 32)
                { if (put_word(&e, (uint32_t) (acc >> 96)) < 0)
                    goto fail;
                  acc <<= 32;
                  fill -= 32;
                }
            }
          else
            { /* final emission group of the entry (trailing run, or the
                 last pair): exact emit_bits path for the tail rule */
              uint32_t c = rbits[x];
              int      n = rlens[x];
              e.accum = (uint32_t) (acc >> 96);
              e.fill = fill;
              if (emit_bits(&e, c, n) < 0)
                goto fail;
              if (c == run_esc_code && n == run_esc_len)
                if (emit_bits(&e, (uint32_t) (run & 0xffff), 16) < 0)
                  goto fail;
              if (k < end)
                { uint8_t s = data[k];
                  k += 1;
                  c = nbits[s];
                  n = nlens[s];
                  if (emit_bits(&e, c, n) < 0)
                    goto fail;
                  if (c == esc_code && n == esc_len)
                    if (emit_bits(&e, s, 8) < 0)
                      goto fail;
                }
              /* hand the live bits back to the accumulator (prev_fill —
                 the tail rule's input — stays in e untouched) */
              acc = ((unsigned __int128) e.accum) << 96;
              fill = e.fill;
              e.accum = 0;
              e.fill = 0;
            }
        }
      e.accum = (uint32_t) (acc >> 96);
      e.fill = fill;
      if (flush_tail(&e) < 0)
        goto fail;
      out_lens[i] = e.len - before;
    }
  free(pair_bits);
  free(pair_len);
  return e.len;

fail:
  free(pair_bits);
  free(pair_len);
  return -1;
}

/* Histogram_Runs (QV.c:702-724) over concatenated entries: one run
 * token (min(len,255)) before each non-rchar literal plus a trailing
 * token when an entry ends in rchar characters.  Single cache-friendly
 * pass; accumulates into hist[256]. */
void dxt_run_hist(
    const uint8_t *data, const int64_t *offs, long long n_entries,
    int rchar, int64_t *hist)
{ long long i;
  for (i = 0; i < n_entries; i++)
    { int64_t k = offs[i], end = offs[i + 1];
      while (k < end)
        { int64_t h = k;
          k = scan_run(data, k, end, (uint8_t) rchar);
          hist[(k - h >= 255) ? 255 : (int) (k - h)] += 1;
          if (k < end)
            k += 1;
        }
    }
}

/* QVcoding_Scan's flat-histogram phase (QV.c:988-991 + 993-1002) in one
 * pass: four 256-bin histograms over the del/ins/mrg/sub streams plus
 * the first index whose delTag is 'n'/'N' (-1 when absent).  hist4 is
 * 4*256 int64, zeroed by the caller. */
void dxt_qv_scan_hists(
    const uint8_t *del, const uint8_t *ins, const uint8_t *mrg,
    const uint8_t *sub, const uint8_t *tag, long long total,
    int64_t *hist4, int64_t *first_n)
{ int64_t *hd = hist4, *hi = hist4 + 256, *hm = hist4 + 512, *hs = hist4 + 768;
  long long i;
  *first_n = -1;
  for (i = 0; i < total; i++)
    { hd[del[i]] += 1;
      hi[ins[i]] += 1;
      hm[mrg[i]] += 1;
      hs[sub[i]] += 1;
      if (*first_n < 0 && (tag[i] == 'n' || tag[i] == 'N'))
        *first_n = i;
    }
}

/* Ragged scatter-copy: entry i's lens[i] bytes move from the running
 * source offset in flat to dst_off[i] in out.  The container assembler's
 * hot loop (one memcpy per entry beats NumPy's fancy-index scatter by
 * ~100x on multi-MB images). */
void dxt_ragged_copy(
    uint8_t *out, const int64_t *dst_off, const uint8_t *flat,
    const int64_t *lens, long long n)
{ int64_t src = 0;
  long long i;
  for (i = 0; i < n; i++)
    { memcpy(out + dst_off[i], flat + src, (size_t) lens[i]);
      src += lens[i];
    }
}

/* Ragged gather-copy: piece i moves from src + src_off[i] to the running
 * output offset.  The text parsers' hot loop (collect sequence lines,
 * drop headers/newlines) — one memcpy per line. */
void dxt_gather_copy(
    uint8_t *out, const uint8_t *src, const int64_t *src_off,
    const int64_t *lens, long long n)
{ int64_t dst = 0;
  long long i;
  for (i = 0; i < n; i++)
    { memcpy(out + dst, src + src_off[i], (size_t) lens[i]);
      dst += lens[i];
    }
}

/* Pack_Tag + Number_Read + Compress_Read for all entries: keep tag bytes
 * where del != rchar (or all, rchar < 0), 2-bit pack.  Returns total. */
long long dxt_pack_tags(
    const uint8_t *tag, const uint8_t *del, const int64_t *offs,
    long long n_entries, int rchar, const uint8_t *number_lut,
    uint8_t *out, long long cap, int64_t *out_lens)
{ int64_t i, k, total = 0;

  for (i = 0; i < n_entries; i++)
    { int64_t  clen = 0;
      uint8_t  acc = 0;
      int      nin = 0;
      int64_t  before = total;
      for (k = offs[i]; k < offs[i + 1]; k++)
        { if (rchar >= 0 && del[k] == (uint8_t) rchar)
            continue;
          acc = (uint8_t) ((acc << 2) | number_lut[tag[k]]);
          nin += 1;
          clen += 1;
          if (nin == 4)
            { if (total + 1 > cap) return -1;
              out[total++] = acc;
              acc = 0;
              nin = 0;
            }
        }
      if (nin > 0)
        { if (total + 1 > cap) return -1;
          out[total++] = (uint8_t) (acc << (2 * (4 - nin)));
        }
      out_lens[i] = total - before;
    }
  return total;
}

/* Merge chunk-local word regions (ops/pack_local.py) into dense packed
 * word streams.  Region q of row i (128 words at words + i*m + 128*q)
 * covers stream words [base>>5, ceil(end/32)) with end the next chunk's
 * base (the row's total bits t[i] for the last live chunk); adjacent
 * regions overlap by at most one straddle word whose bit ranges are
 * disjoint, so the combine is OR.  Row i's raw = ceil(t[i]/32) words
 * are written at dst + dst_offs[i] (zeroed first). */
void dxt_region_merge(const int32_t *words, const int32_t *base,
                      const long long *t, long long n, long long m,
                      uint32_t *dst, const long long *dst_offs)
{ int64_t i, q, j;
  int64_t c = m / 128;

  for (i = 0; i < n; i++)
    { const int32_t  *wrow = words + i * m;
      const int32_t  *brow = base + i * c;
      uint32_t       *drow = dst + dst_offs[i];
      int64_t         raw = (t[i] + 31) >> 5;

      for (j = 0; j < raw; j++)
        drow[j] = 0;
      for (q = 0; q < c; q++)
        { int64_t b0 = (uint32_t) brow[q];
          int64_t b1 = (q + 1 < c) ? (uint32_t) brow[q + 1] : t[i];
          int64_t w0, nw;

          if (b1 <= b0)
            continue;
          if (b1 > t[i])        /* never write past the row's raw words */
            b1 = t[i];
          w0 = b0 >> 5;
          nw = ((b1 + 31) >> 5) - w0;
          if (w0 >= raw)
            continue;
          if (nw > raw - w0)
            nw = raw - w0;
          /* OR throughout: regions only overlap at bit-disjoint straddle
             words, and all-zero pad chunks (stats lanes beyond a
             narrower channel's real chunk count read as base 0) must
             not clobber already-merged words */
          for (j = 0; j < nw; j++)
            drow[w0 + j] |= (uint32_t) wrow[128 * q + j];
        }
    }
}
