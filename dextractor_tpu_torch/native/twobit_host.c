/* Host-side 2-bit codec fast paths (CPU-only deployments).
 *
 * The port's copy of dextractor_tpu/native/twobit_host.c.  The CUDA
 * kernels (ops/csrc/twobit.cu: dxt_pack2bit, dxt_unpack2bit) own the
 * device path; these single-pass loops are the host path (device=False)
 * at C-tool speed, and the byte oracle the device path is held to.
 *
 * Semantics: Compress_Read / Uncompress_Read (DB.c:319-363) — first base
 * in bits 7-6 — and undexta.c:241-264's width-wrapped text emission.
 *
 * Build: gcc -O2 -shared -fPIC twobit_host.c -o _twobit_host.so
 */

#include <stdint.h>
#include <string.h>

/* Pack concatenated symbol streams (offs[n+1] boundaries) to 2-bit,
 * each entry padded to a byte boundary with zero bits (DB.c:334 tail).
 * number_lut maps ascii -> 0..3.  Returns total packed bytes or -1. */
long long dxt_pack_seq(
    const uint8_t *sym, const int64_t *offs, long long n,
    const uint8_t *number_lut, uint8_t *out, long long cap,
    int64_t *out_lens)
{ long long i;
  int64_t   total = 0;
  for (i = 0; i < n; i++)
    { int64_t k = offs[i], end = offs[i + 1];
      int64_t before = total;
      while (k + 4 <= end)
        { if (total >= cap) return -1;
          out[total++] = (uint8_t)
             ((number_lut[sym[k]] << 6) | (number_lut[sym[k + 1]] << 4)
            | (number_lut[sym[k + 2]] << 2) | number_lut[sym[k + 3]]);
          k += 4;
        }
      if (k < end)
        { uint8_t acc = 0;
          int     sh = 6;
          if (total >= cap) return -1;
          for (; k < end; k++, sh -= 2)
            acc |= (uint8_t) (number_lut[sym[k]] << sh);
          out[total++] = acc;
        }
      out_lens[i] = total - before;
    }
  return total;
}

/* Count newline-terminated lines and lines starting with hdr_ch.
 * The caller uses the counts to size dxt_seq_scan's outputs. */
void dxt_line_stats(const uint8_t *buf, long long n, int hdr_ch,
                    int64_t *n_lines, int64_t *n_hdrs)
{ const uint8_t *p = buf, *end = buf + n;
  int64_t lines = 0, hdrs = 0;
  while (p < end)
    { const uint8_t *nl = memchr(p, '\n', (size_t) (end - p));
      if (nl == 0)
        break;                      /* unterminated tail: not a line */
      lines += 1;
      if (*p == (uint8_t) hdr_ch)
        hdrs += 1;
      p = nl + 1;
    }
  *n_lines = lines;
  *n_hdrs = hdrs;
}

/* One-pass .fasta/.arrow scan: header lines get their [start,end) byte
 * spans recorded; sequence lines are memcpy'd (newline-free) into flat
 * and accumulate rec_lens of the current record.  Returns total flat
 * bytes, or -1 when a sequence line precedes the first header.  The
 * caller sizes hdr_starts/hdr_ends/rec_lens from dxt_line_stats and
 * flat at n (an upper bound on sequence bytes). */
long long dxt_seq_scan(const uint8_t *buf, long long n, int hdr_ch,
                       int64_t *hdr_starts, int64_t *hdr_ends,
                       uint8_t *flat, int64_t *rec_lens)
{ const uint8_t *p = buf, *end = buf + n;
  int64_t total = 0;
  long long rec = -1;
  while (p < end)
    { const uint8_t *nl = memchr(p, '\n', (size_t) (end - p));
      size_t         len;
      if (nl == 0)
        break;
      len = (size_t) (nl - p);
      if (*p == (uint8_t) hdr_ch)
        { rec += 1;
          hdr_starts[rec] = p - buf;
          hdr_ends[rec] = nl - buf;
          rec_lens[rec] = 0;
        }
      else
        { if (rec < 0)
            return -1;
          memcpy(flat + total, p, len);
          total += (int64_t) len;
          rec_lens[rec] += (int64_t) len;
        }
      p = nl + 1;
    }
  return total;
}

/* Unpack 2-bit payloads into width-wrapped ascii text.
 *
 * Entry i's packed bytes start at pay[pay_offs[i]]; rlens[i] symbols are
 * written at out + seq_offs[i] as letter_lut-mapped ascii with a '\n'
 * after every `width` symbols and after the final partial line.  The
 * caller sizes out and interleaves headers itself.  Returns 0. */
long long dxt_unpack_text(
    const uint8_t *pay, const int64_t *pay_offs, const int64_t *rlens,
    long long n, long long width, const uint8_t *letter_lut,
    uint8_t *out, const int64_t *seq_offs)
{ long long i;
  uint8_t   quad[256][4];
  int       c;
  for (c = 0; c < 256; c++)
    { quad[c][0] = letter_lut[(c >> 6) & 3];
      quad[c][1] = letter_lut[(c >> 4) & 3];
      quad[c][2] = letter_lut[(c >> 2) & 3];
      quad[c][3] = letter_lut[c & 3];
    }
  for (i = 0; i < n; i++)
    { const uint8_t *p = pay + pay_offs[i];
      uint8_t       *o = out + seq_offs[i];
      int64_t        len = rlens[i];
      int64_t        j = 0;
      while (j < len)                /* one text line per iteration; */
        { int64_t end = j + width;   /* zero-length entries emit none */
          if (end > len)
            end = len;
          while ((j & 3) != 0 && j < end)
            { *o++ = letter_lut[(p[j >> 2] >> (6 - 2 * (j & 3))) & 3];
              j += 1;
            }
          while (j + 4 <= end)
            { memcpy(o, quad[p[j >> 2]], 4);
              o += 4; j += 4;
            }
          while (j < end)
            { *o++ = letter_lut[(p[j >> 2] >> (6 - 2 * (j & 3))) & 3];
              j += 1;
            }
          *o++ = '\n';
        }
    }
  return 0;
}
