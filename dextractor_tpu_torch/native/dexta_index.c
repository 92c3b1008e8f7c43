/* .dexta / .dexar entry walker.
 *
 * Entry sizes depend on the well-delta escape bytes and the beg/end fields
 * inside each header, so the container parse is a (cheap) sequential chain
 * (undexta.c:175-255).  This walker records per-entry metadata and payload
 * offsets at memory speed; payload gathering stays vectorized and the
 * 2-bit unpacking runs on the device or in twobit_host.c.  The port's copy
 * of dextractor_tpu/native/dexta_index.c.
 *
 * mode: 0 = .dexta new (i32 beg,end,qv), 1 = .dexar (i32 beg,end + 4xu16),
 *       2 = .dexta legacy (u16 beg,end,qv)
 * Build: gcc -O2 -shared -fPIC dexta_index.c -o _dexta_index.so
 */

#include <stdint.h>
#include <string.h>

long long dxt_dexta_walk(
    const uint8_t *buf, long long size, long long off0, int mode,
    long long cap,
    int32_t *wells, int32_t *begs, int32_t *ends, int32_t *qvs,
    uint16_t *cnrs /* cap*4, mode 1 only */,
    long long *poffs, long long *plens)
{ int64_t off = off0;
  int64_t ne = 0;
  int     well = 0;

  while (off < size && ne < cap)
    { uint8_t byte;
      int32_t beg, end, qv = 0;
      int64_t clen;

      byte = buf[off++];
      while (byte == 255)
        { well += 255;
          if (off >= size) return -2;
          byte = buf[off++];
        }
      well += byte;

      if (mode == 0)
        { if (off + 12 > size) return -2;
          memcpy(&beg, buf + off, 4);
          memcpy(&end, buf + off + 4, 4);
          memcpy(&qv, buf + off + 8, 4);
          off += 12;
        }
      else if (mode == 1)
        { if (off + 16 > size) return -2;
          memcpy(&beg, buf + off, 4);
          memcpy(&end, buf + off + 4, 4);
          memcpy(cnrs + 4 * ne, buf + off + 8, 8);
          off += 16;
        }
      else
        { uint16_t h;
          if (off + 6 > size) return -2;
          memcpy(&h, buf + off, 2); beg = h;
          memcpy(&h, buf + off + 2, 2); end = h;
          memcpy(&h, buf + off + 4, 2); qv = h;
          off += 6;
        }

      clen = ((int64_t) end - beg + 3) >> 2;
      if (clen < 0 || off + clen > size)
        return -2;
      wells[ne] = well;
      begs[ne] = beg;
      ends[ne] = end;
      qvs[ne] = qv;
      poffs[ne] = off;
      plens[ne] = clen;
      off += clen;
      ne += 1;
    }
  return ne;
}
