/* Sequential .dexqv entry-chain decoder.
 *
 * Huffman decode of a .dexqv file is a bit-serial chain: every stream's
 * byte length is only known after decoding it, and the five streams of the
 * entries are butted end to end (QV.c:1381-1426).  This walker resolves the
 * chain at C speed — the host-side "data loader" of the framework — while
 * all byte-parallel post-processing (run expansion already done here is
 * cheap; Phred shifts, container assembly, text framing) stays vectorized
 * in NumPy/JAX.  It also doubles as the boundary indexer for the TPU batch
 * decoder (materialize=0 records offsets only).
 *
 * The bitstream semantics replicate Decode/Decode_Run (QV.c:510-691): 16-bit
 * peeks into a 64K lookup table, escape symbol + 8-bit literal (16-bit run
 * length), and the encoder's word-count formula for stream advancement.
 *
 * Build: gcc -O2 -shared -fPIC qv_decode.c -o _qv_decode.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct
  { const uint8_t *buf;
    int64_t        size;
    int64_t        base;    /* byte offset of current stream */
    int64_t        pos;     /* bit position within the stream */
  } BitRead;

static inline uint32_t word_at(const BitRead *b, int64_t byteoff)
{ uint32_t w = 0;
  int64_t  n = b->size - byteoff;
  if (n >= 4)
    memcpy(&w, b->buf + byteoff, 4);
  else if (n > 0)
    memcpy(&w, b->buf + byteoff, (size_t) n);
  return w;     /* little-endian host */
}

/* Register-resident decode window: the valid bits live left-aligned in
 * ``icode`` (top ``ilen`` bits).  One branch + one 32-bit load per ~32
 * consumed bits instead of two 8-byte reassemblies per symbol — the same
 * structure as the reference's 64-bit GET window (QV.c:537-568), kept in
 * locals so the compiler can hold it in registers. */
typedef struct
  { uint64_t icode;
    int      ilen;
    int64_t  wordi;   /* next u32 word index to load */
  } Win;

static inline void win_init(Win *w)
{ w->icode = 0; w->ilen = 0; w->wordi = 0; }

static inline void win_fill(Win *w, const BitRead *b)
{ while (w->ilen <= 32)
    { uint32_t nw = word_at(b, b->base + 4 * w->wordi);
      w->wordi += 1;
      w->icode |= ((uint64_t) nw) << (32 - w->ilen);
      w->ilen += 32;
    }
}

#define WPEEK16(w)   ((uint32_t) ((w).icode >> 48))
#define WDROP(w, n)  ((w).icode <<= (n), (w).ilen -= (n))

/* Fused decode tables: entry = (codelen << 8) | symbol, so one load
 * replaces the lookup->lens dependent-load pair.  ``small`` covers the
 * 11-bit peek prefix (4 KB, L1-resident) for codes <= 11 bits — the
 * frequent symbols — with 0 meaning "consult the full 128 KB table".
 * The reference walks the raw 64K int32 table per symbol (QV.c:560);
 * this halves the footprint and keeps the hot set in L1. */
#define SMALL_BITS 11
#define PAIR_BITS  13
typedef struct
  { uint16_t big[65536];
    uint16_t small[1 << SMALL_BITS];
    uint32_t pair[1 << PAIR_BITS];   /* two escape-free codes fitting in
                                        PAIR_BITS: sym2<<18|sym1<<10|
                                        n2<<5|ntot — n2 alone feeds the
                                        tail-padding rule (stream_words'
                                        ``last``); 0 = no pair here */
  } FusedTab;

static void fuse_tab(FusedTab *t, const int32_t *look, const uint8_t *lens,
                     int type)
{ int64_t p;
  int     esc = (type == 2) ? 255 : 256;
  for (p = 0; p < 65536; p++)
    { int c = look[p];
      int n = (c >= 0 && c < 256) ? lens[c] : 0;
      t->big[p] = (uint16_t) ((n << 8) | (c & 255));
    }
  for (p = 0; p < (1 << SMALL_BITS); p++)
    { uint16_t e = t->big[p << (16 - SMALL_BITS)];
      t->small[p] = ((e >> 8) <= SMALL_BITS) ? e : 0;
    }
  for (p = 0; p < (1 << PAIR_BITS); p++)
    { uint16_t e1 = t->big[p << (16 - PAIR_BITS)];
      int      c1 = e1 & 255, n1 = e1 >> 8;
      t->pair[p] = 0;
      if (n1 >= 1 && n1 < PAIR_BITS && c1 != esc)
        { uint32_t rest = ((uint32_t) p << (16 - PAIR_BITS + n1)) & 0xFFFF;
          uint16_t e2 = t->big[rest];
          int      c2 = e2 & 255, n2 = e2 >> 8;
          if (n2 >= 1 && n1 + n2 <= PAIR_BITS && c2 != esc)
            t->pair[p] = ((uint32_t) c2 << 18) | ((uint32_t) c1 << 10)
                       | ((uint32_t) n2 << 5) | (uint32_t) (n1 + n2);
        }
    }
}

static inline uint32_t tab_get(const FusedTab *t, uint32_t p16)
{ uint32_t e = t->small[p16 >> (16 - SMALL_BITS)];
  if (e == 0)
    e = t->big[p16];
  return e;
}

/* words the encoder wrote for a stream (tail-padding rule, QV.c:436-442) */
static inline int64_t stream_words(int64_t total, int last)
{ int64_t nfull, olen, llen;
  if (total == 0)
    return 0;
  nfull = total >> 5;
  olen = total & 31;
  llen = (total - last) & 31;
  if (olen > 0)
    return nfull + ((llen > 16 && olen > llen) ? 2 : 1);
  return nfull + (llen > 16 ? 1 : 0);
}

/* plain stream: decode rlen symbols, return words consumed (or -1) */
/* seg/ck: when ck != NULL, record b->pos (bit offset within this channel
 * stream) immediately BEFORE symbols seg, 2*seg, ... — the device decodes
 * each segment as an independent chain from its checkpoint.  seg must be
 * a power of two; the two-symbol pair fast path is suppressed across
 * boundaries so checkpoints land exactly. */
static int64_t dec_plain(BitRead *b, const FusedTab *tab,
                         int type, uint8_t *out, int64_t rlen,
                         int64_t seg, int32_t *ck)
{ int     signal = (type == 2) ? 255 : 256;
  int     last = 0;
  int64_t j;
  int64_t m = seg - 1;
  Win     w;

  win_init(&w);
  for (j = 0; j < rlen; j++)
    { int c, n;
      uint32_t e;
      if (ck != NULL && j != 0 && (j & m) == 0)
        ck[(j >> __builtin_ctzll((uint64_t) seg)) - 1] = (int32_t) b->pos;
      win_fill(&w, b);                /* >= 24 bits: code + escape literal */
      if (j + 1 < rlen && !(ck != NULL && ((j + 1) & m) == 0))
        { uint32_t pr = tab->pair[WPEEK16(w) >> (16 - PAIR_BITS)];
          if (pr != 0)                /* two escape-free codes at once */
            { n = (int) (pr & 31);
              WDROP(w, n);
              b->pos += n;
              last = (int) ((pr >> 5) & 31);   /* the 2nd code's length
                                                  alone drives the tail-
                                                  padding rule */
              if (out != NULL)
                { out[j] = (uint8_t) (pr >> 10);
                  out[j + 1] = (uint8_t) (pr >> 18);
                }
              j += 1;
              continue;
            }
        }
      e = tab_get(tab, WPEEK16(w));
      c = (int) (e & 255);
      n = (int) (e >> 8);
      WDROP(w, n);
      b->pos += n;
      last = n;
      if (c == signal)
        { c = (int) (w.icode >> 56);
          WDROP(w, 8);
          b->pos += 8;
          last = 8;
        }
      if (out != NULL)
        out[j] = (uint8_t) c;
    }
  return stream_words(b->pos, last);
}

/* RLE stream: decode rlen expanded symbols; *ntok (NULL-able) counts
 * (run, literal) token pairs — the batch decoder's chain-length unit */
/* seg/ck_*: when ck_bits != NULL, record a checkpoint for every symbol
 * boundary k*seg (k >= 1): the bit position the device segment chain
 * starts from, the literal (token) index t0 its tag codes start at, and
 * the run carry.  A boundary crossed by run emission (j < k*seg <= j+c)
 * checkpoints AT THIS PAIR'S LITERAL with carry = leftover rchars to
 * prepend; a boundary right after a literal checkpoints at the next run
 * code with carry = -1 ("start normally").  The device run chain clamps
 * emission at its segment rlen (emitted1 = min(...)), so the upstream
 * segment needs no change to stop mid-run. */
static int64_t dec_run(BitRead *b, const FusedTab *ntab, int ntype,
                       const FusedTab *rtab,
                       uint8_t *out, int64_t rlen, int rchar, int64_t *ntok,
                       int64_t seg, int32_t *ck_bits, int32_t *ck_tok,
                       int32_t *ck_carry)
{ int     nsignal = (ntype == 2) ? 255 : 256;
  int     last = 0;
  int64_t j = 0;
  int64_t toks = 0;
  int64_t lits = 0;
  int64_t next = seg;
  Win     w;

  win_init(&w);
  while (j < rlen)
    { int c, n;
      uint32_t t;
      toks += 1;
      win_fill(&w, b);                /* run code + 16-bit length literal */
      t = tab_get(rtab, WPEEK16(w));
      c = (int) (t & 255);
      n = (int) (t >> 8);
      WDROP(w, n);
      b->pos += n;
      last = n;
      if (c == 255)
        { c = (int) WPEEK16(w);
          WDROP(w, 16);
          b->pos += 16;
          last = 16;
        }
      { int64_t e = j + c;
        if (e > rlen)
          e = rlen;
        if (ck_bits != NULL)
          while (next <= e && next < rlen)
            { int64_t k = next / seg - 1;
              ck_bits[k] = (int32_t) b->pos;      /* at this pair's literal */
              ck_tok[k] = (int32_t) lits;
              ck_carry[k] = (int32_t) (e - next); /* leftover rchars */
              next += seg;
            }
        if (out != NULL)
          memset(out + j, rchar, (size_t) (e - j));
        j = e;
      }
      if (j < rlen)
        { int s;
          win_fill(&w, b);
          t = tab_get(ntab, WPEEK16(w));
          s = (int) (t & 255);
          n = (int) (t >> 8);
          WDROP(w, n);
          b->pos += n;
          last = n;
          if (s == nsignal)
            { s = (int) (w.icode >> 56);
              WDROP(w, 8);
              b->pos += 8;
              last = 8;
            }
          if (out != NULL)
            out[j] = (uint8_t) s;
          j += 1;
          lits += 1;
          if (ck_bits != NULL && j == next && next < rlen)
            { int64_t k = next / seg - 1;
              ck_bits[k] = (int32_t) b->pos;      /* at the next run code */
              ck_tok[k] = (int32_t) lits;
              ck_carry[k] = -1;                   /* start normally */
              next += seg;
            }
        }
    }
  if (ntok != NULL)
    *ntok = toks;
  return stream_words(b->pos, last);
}

static const char LOWER[5] = { 'a', 'c', 'g', 't', 0 };

/* Assemble .quiva text (undexqv.c:182-207's fprintf loop, batched):
 * per entry a pre-rendered header line then the five stream lines.
 * streams is stream-major with row stride stream_stride (the walker's
 * output layout).  Returns bytes written. */
long long dxt_quiva_text(
    const uint8_t *streams, long long stream_stride, long long ne,
    const long long *elens, const uint8_t *hdrs, const long long *hdr_lens,
    uint8_t *out)
{ int64_t spos = 0, hpos = 0, opos = 0;
  int64_t i, s;
  for (i = 0; i < ne; i++)
    { int64_t L = elens[i];
      memcpy(out + opos, hdrs + hpos, (size_t) hdr_lens[i]);
      opos += hdr_lens[i];
      hpos += hdr_lens[i];
      out[opos++] = '\n';
      for (s = 0; s < 5; s++)
        { memcpy(out + opos, streams + s * stream_stride + spos, (size_t) L);
          opos += L;
          out[opos++] = '\n';
        }
      spos += L;
    }
  return opos;
}

/* Walk every entry of a .dexqv payload.
 *
 * schemes: ns x (65536 int32 lookup || 256 uint8 lens || 1 uint8 type),
 * sid[6]: scheme index for del, drun, ins, mrg, sub, srun (-1 if absent).
 * Outputs (all may be partially filled; return = entries decoded, <0 error):
 *   wells/begs/ends/qvs  per entry
 *   eoffs[e]             byte offset of entry e's first stream
 *   elens[e]             rlen of entry e
 *   out[5*cap_total]     decoded streams, stream-major (out + s*cap_total)
 *                        entries concatenated; NULL-able via materialize=0
 *   coffs[5*e..]         NULL-able: per-entry byte offsets, relative to
 *                        eoffs[e], of the tag / ins / mrg / sub streams
 *                        and the entry end (del starts at 0) — lets the
 *                        batch decoder slice per-channel rectangles
 *   ntoks[2*e..]         NULL-able: (run,literal) token-pair counts of the
 *                        del and sub RLE chains (0 when plain) — a tight
 *                        static bound for the device run chains
 */
/* Checkpoint outputs (all may be NULL): with seg a power of two and
 * ck_offs the caller-computed prefix sums of per-entry boundary counts
 * nb_i = max(ceil(rlen_i/seg) - 1, 0) (known from a prior walk), the
 * walker records per-channel segment checkpoints: ckb holds 4 planes of
 * btot bit offsets (del, ins, mrg, sub), ckt/ckc hold 2 planes each of
 * literal-token indices / run carries (del, sub; run-coded channels
 * only).  Long reads then decode on the device as many short chains.
 *
 * Headerless mode (Dazzler DB .qvs payloads, DB.c:2575-2621: entries
 * are butted five-stream blobs with NO well/beg/end/qv header — read
 * lengths live in the .idx): pass rlens_in (n_in entries).  The walker
 * then takes rlen = rlens_in[ne], leaves wells/begs/ends/qvs zeroed,
 * and stops after n_in entries. */
long long dxt_qv_walk(
    const uint8_t *buf, long long size, long long off0,
    const int32_t *lookups, const uint8_t *lens, const uint8_t *types,
    const int32_t *sid, int del_char, int sub_char, int newv,
    long long cap_entries, long long cap_total,
    int32_t *wells, int32_t *begs, int32_t *ends, int32_t *qvs,
    long long *eoffs, long long *elens,
    uint8_t *out, int materialize, int32_t *coffs, int32_t *ntoks,
    long long seg, long long btot, const long long *ck_offs,
    int32_t *ckb, int32_t *ckt, int32_t *ckc,
    const long long *rlens_in, long long n_in)
{
#define LOOK(i) (lookups + (int64_t) (i) * 65536)
#define LENS(i) (lens + (int64_t) (i) * 256)
  int64_t off = off0;
  int64_t ne = 0;
  int64_t total = 0;
  int     well = 0;
  FusedTab *tabs;
  int       nschemes = 0, si;

  for (si = 0; si < 6; si++)
    if (sid[si] + 1 > nschemes)
      nschemes = sid[si] + 1;
  tabs = (FusedTab *) malloc(sizeof(FusedTab) * (size_t) (nschemes ? nschemes : 1));
  if (tabs == NULL)
    return -4;
  for (si = 0; si < nschemes; si++)
    fuse_tab(tabs + si, LOOK(si), LENS(si), types[si]);
#define TAB(i) (tabs + (i))
#define WRET(v) do { free(tabs); return (v); } while (0)

  while ((rlens_in != NULL ? ne < n_in : off < size) && ne < cap_entries)
    { int64_t rlen, clen, tlen, w;
      int     beg, end, qv;
      uint8_t byte;
      BitRead br;
      uint8_t *odel, *otag, *oins, *omrg, *osub;

      if (rlens_in != NULL)
        { rlen = rlens_in[ne];
          beg = 0; end = (int) rlen; qv = 0;
          if (off > size) WRET(-2);
        }
      else
        { byte = buf[off++];
          while (byte == 255)
            { well += 255;
              if (off >= size) WRET(-2);
              byte = buf[off++];
            }
          well += byte;

          if (newv)
            { if (off + 12 > size) WRET(-2);
              memcpy(&beg, buf + off, 4);
              memcpy(&end, buf + off + 4, 4);
              memcpy(&qv, buf + off + 8, 4);
              off += 12;
            }
          else
            { uint16_t h;
              if (off + 6 > size) WRET(-2);
              memcpy(&h, buf + off, 2); beg = h;
              memcpy(&h, buf + off + 2, 2); end = h;
              memcpy(&h, buf + off + 4, 2); qv = h;
              off += 6;
            }
          rlen = (int64_t) end - beg;
        }
      if (rlen < 0 || total + rlen > cap_total)
        WRET(-3);

      wells[ne] = well;
      begs[ne] = beg;
      ends[ne] = end;
      qvs[ne] = qv;
      eoffs[ne] = off;
      elens[ne] = rlen;

      { int32_t *cd = NULL, *ci = NULL, *cm = NULL, *cs = NULL;
        int32_t *ctd = NULL, *ccd = NULL, *cts = NULL, *ccs = NULL;
        if (seg > 0 && ckb != NULL && ck_offs != NULL)
          { int64_t cb = ck_offs[ne];
            cd = ckb + cb;
            ci = ckb + btot + cb;
            cm = ckb + 2 * btot + cb;
            cs = ckb + 3 * btot + cb;
            if (ckt != NULL)
              { ctd = ckt + cb;
                cts = ckt + btot + cb;
              }
            if (ckc != NULL)
              { ccd = ckc + cb;
                ccs = ckc + btot + cb;
              }
          }

      odel = materialize ? out + total : NULL;
      otag = materialize ? out + cap_total + total : NULL;
      oins = materialize ? out + 2 * cap_total + total : NULL;
      omrg = materialize ? out + 3 * cap_total + total : NULL;
      osub = materialize ? out + 4 * cap_total + total : NULL;

      /* delQV — note: even with materialize=0 the del content is needed
         for the packed-tag length, so it is always decoded */
      { /* lens-only walks still need the del content for the packed-tag
           length; grow the scratch to the longest read seen (reads can
           exceed 1 Mbp, so no fixed cap) */
        static uint8_t *scratch = NULL;
        static int64_t  scratch_cap = 0;
        uint8_t *dd = odel;
        if (dd == NULL)
          { if (rlen > scratch_cap)
              { int64_t  nc = (rlen < (1 << 20)) ? (1 << 20)
                                                 : rlen + (rlen >> 2);
                uint8_t *ns = (uint8_t *) realloc(scratch, (size_t) nc);
                if (ns == NULL) WRET(-4);
                scratch = ns;
                scratch_cap = nc;
              }
            dd = scratch;
          }
        br.buf = buf; br.size = size; br.base = off; br.pos = 0;
        if (del_char < 0)
          { w = dec_plain(&br, TAB(sid[0]), types[sid[0]], dd, rlen,
                          seg, cd);
            clen = rlen;
            if (ntoks != NULL)
              ntoks[2 * ne] = 0;
          }
        else
          { int64_t k, dtk = 0;
            w = dec_run(&br, TAB(sid[0]), types[sid[0]],
                        TAB(sid[1]), dd, rlen, del_char, &dtk,
                        seg, cd, ctd, ccd);
            clen = 0;
            for (k = 0; k < rlen; k++)
              clen += (dd[k] != (uint8_t) del_char);
            if (ntoks != NULL)
              ntoks[2 * ne] = (int32_t) dtk;
          }
        off += 4 * w;
        if (coffs != NULL)
          coffs[5 * ne] = (int32_t) (off - eoffs[ne]);

        /* packed delTag: 2-bit unpack + lower + Unpack_Tag (QV.c:1437-1461) */
        tlen = (clen + 3) >> 2;
        if (off + tlen > size)
          WRET(-2);
        if (materialize)
          { int64_t k, p = clen - 1;
            if (del_char < 0)
              { for (k = 0; k < rlen; k++)
                  { uint8_t pb = buf[off + (k >> 2)];
                    otag[k] = LOWER[(pb >> (6 - 2 * (k & 3))) & 3];
                  }
              }
            else
              { for (k = rlen - 1; k >= 0; k--)
                  { if (dd[k] == (uint8_t) del_char)
                      otag[k] = 'n';
                    else
                      { uint8_t pb = buf[off + (p >> 2)];
                        otag[k] = LOWER[(pb >> (6 - 2 * (p & 3))) & 3];
                        p -= 1;
                      }
                  }
              }
          }
        off += tlen;
      }
      if (coffs != NULL)
        coffs[5 * ne + 1] = (int32_t) (off - eoffs[ne]);

      br.buf = buf; br.size = size; br.base = off; br.pos = 0;
      w = dec_plain(&br, TAB(sid[2]), types[sid[2]], oins, rlen, seg, ci);
      off += 4 * w;
      if (coffs != NULL)
        coffs[5 * ne + 2] = (int32_t) (off - eoffs[ne]);

      br.buf = buf; br.size = size; br.base = off; br.pos = 0;
      w = dec_plain(&br, TAB(sid[3]), types[sid[3]], omrg, rlen, seg, cm);
      off += 4 * w;
      if (coffs != NULL)
        coffs[5 * ne + 3] = (int32_t) (off - eoffs[ne]);

      br.buf = buf; br.size = size; br.base = off; br.pos = 0;
      if (sub_char < 0)
        { w = dec_plain(&br, TAB(sid[4]), types[sid[4]], osub, rlen,
                        seg, cs);
          if (ntoks != NULL)
            ntoks[2 * ne + 1] = 0;
        }
      else
        { int64_t stk = 0;
          w = dec_run(&br, TAB(sid[4]), types[sid[4]],
                      TAB(sid[5]), osub, rlen, sub_char, &stk,
                      seg, cs, cts, ccs);
          if (ntoks != NULL)
            ntoks[2 * ne + 1] = (int32_t) stk;
        }
      off += 4 * w;
      if (coffs != NULL)
        coffs[5 * ne + 4] = (int32_t) (off - eoffs[ne]);
      }

      if (off > size)
        WRET(-2);
      total += rlen;
      ne += 1;
    }
  WRET(ne);
}
