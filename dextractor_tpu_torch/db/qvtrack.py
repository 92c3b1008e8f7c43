"""The ``qvchk`` QV-decode index track: per-read channel boundaries +
segment checkpoints for the Dazzler DB QV path.

The reference DB stores only ``coff`` per read (DAZZ_READ, DB.h:307-318)
— enough for the sequential Load_QVentry walk (DB.c:2575-2621) but not
for the batched device decoder, which wants per-channel stream
boundaries (to slice dense rectangles) and, for long reads, the
checkpoint planes that let each read decode as short full-speed chains
(codecs/qv_batch.fused_decode_entries_seg).  dex2DB writes this as an
ordinary Dazzler custom track (``.NAME.qvchk.anno/.data`` — the same
track machinery as DB.c:1649-2312, so downstream Dazzler tools simply
see an unknown track and ignore it); ``load_all_qventries`` uses it when
present and falls back to a native headerless lens walk when not, so
the track is purely an index cache.

Per-read record (little-endian i32 words):

    [ c_tag, c_ins, c_mrg, c_sub, c_end,      # byte offsets rel. coff
      ntok_del, ntok_sub,                     # RLE token-pair counts
      nb,                                     # checkpoint count
      ckb_del[nb], ckb_ins[nb], ckb_mrg[nb], ckb_sub[nb],   # bit offsets
      ckt_del[nb], ckt_sub[nb],               # literal-token indices
      ckc_del[nb], ckc_sub[nb] ]              # run carries (-1 = none)

The segment size rides as a DB_INT extra named ``seg`` (Read_Extra
semantics, DB.c:2114-2156).  Checkpoint semantics match
codecs/qv_codec._index_checkpoints (native walker planes).  The port's own
copy of ``dextractor_tpu/db/qvtrack.py``: the same track files, byte for
byte.
"""

from __future__ import annotations

import numpy as np

from .tracks import Track, Extra, write_track, check_track, open_track
from .tracks import DB_INT, DB_EXACT

QVCHK = "qvchk"


def _cell_groups(qv, nreads, first: int = 0):
    """Contiguous (coding_index, read_slice) groups in table order over
    reads [first, nreads)."""
    table = np.asarray(qv.table)
    groups = []
    i = first
    while i < nreads:
        ci = int(table[i])
        j = i
        while j < nreads and int(table[j]) == ci:
            j += 1
        groups.append((ci, slice(i, j)))
        i = j
    return groups


def index_cell(data, coding, starts, rlens, seg):
    """Headerless lens walk of one cell's butted QV entries.

    Returns (coffs (n, 5) i32, ntoks (n, 2) i32, ck or None) where ck is
    the fused_decode_entries_seg checkpoint tuple with cell-local
    ck_offs, or None (native shim unavailable / walk failed)."""
    from ..codecs.qv_codec import _index_native, _index_checkpoints

    rl = np.asarray(rlens, np.int64)
    res = _index_native(data, coding, int(starts[0]), True, rlens=rl)
    if res is None:
        return None
    eoffs, elens, coffs, ntoks = res[4:8]
    if not np.array_equal(eoffs, np.asarray(starts, np.int64)):
        return None                  # stream chain disagrees with the .idx
    ck = None
    if rl.max(initial=0) > seg:
        ck = _index_checkpoints(data, coding, int(starts[0]), True, elens,
                                seg=seg, rlens=rl)
    return coffs, ntoks, ck


def build_qvchk_track(db, seg: int | None = None,
                      first: int = 0) -> Track | None:
    """Walk an open DB's .qvs payload and build the qvchk track, or None
    when the native walker is unavailable.

    ``first`` > 0 indexes only reads [first, nreads) — the incremental
    append path (dex2DB append touches only the new cells,
    dex2DB.c:577-685, so the track extension should too).  ``first``
    must sit on a cell boundary (appends add whole cells)."""
    from ..codecs.qv_codec import SEG_DECODE

    seg = SEG_DECODE if seg is None else int(seg)
    db.open_qvs()
    qv = db._qv
    rlens = db.reads["rlen"].astype(np.int64)
    starts = db.reads["coff"].astype(np.int64)
    n = db.nreads
    if first and int(np.asarray(qv.table)[first - 1]) \
            == int(np.asarray(qv.table)[first]):
        return None            # not a cell boundary: caller must rebuild
    recs = []
    for ci, sl in _cell_groups(qv, n, first):
        got = index_cell(qv.data, qv.codings[ci], starts[sl], rlens[sl],
                         seg)
        if got is None:
            return None
        coffs, ntoks, ck = got
        rl = rlens[sl]
        nb = np.maximum((rl + seg - 1) // seg - 1, 0).astype(np.int64)
        if ck is None:
            nb[:] = 0
        for i in range(sl.stop - sl.start):
            w = [np.asarray(coffs[i], np.int32),
                 np.asarray(ntoks[i], np.int32),
                 np.asarray([nb[i]], np.int32)]
            if nb[i]:
                _, cko, ckb, ckt, ckc = ck
                b0, b1 = int(cko[i]), int(cko[i + 1])
                w += [ckb[0, b0:b1], ckb[1, b0:b1], ckb[2, b0:b1],
                      ckb[3, b0:b1], ckt[0, b0:b1], ckt[1, b0:b1],
                      ckc[0, b0:b1], ckc[1, b0:b1]]
            recs.append(np.concatenate(w).astype(np.int32))
    data = (np.concatenate(recs).view(np.uint8) if recs
            else np.empty(0, np.uint8))
    anno = np.zeros(n - first + 1, np.int64)
    if recs:
        np.cumsum([4 * len(r) for r in recs], out=anno[1:])
    extra = Extra(DB_INT, DB_EXACT, b"seg",
                  np.array([seg], np.int64))
    return Track(name=QVCHK, size=8, nreads=n - first, anno=anno,
                 data=data, extras=[extra])


def _read_raw_track(base: str):
    """Raw (nreads, anno i64, data, seg) of an on-disk qvchk track read
    without a DB handle (after an append the DB header's ureads no
    longer matches the stale track, so check_track would reject it —
    exactly the state the incremental extension wants to fix)."""
    import os
    import struct
    from .tracks import _parse_extras

    apath, dpath = f"{base}.{QVCHK}.anno", f"{base}.{QVCHK}.data"
    if not (os.path.exists(apath) and os.path.exists(dpath)):
        return None
    with open(apath, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        return None
    tracklen, size = struct.unpack_from("<ii", buf, 0)
    if size != 8 or tracklen < 0:
        return None
    off = 8 + 8 * (tracklen + 1)
    if len(buf) < off:
        return None
    anno = np.frombuffer(buf, np.int64, count=tracklen + 1, offset=8)
    try:
        extras = _parse_extras(buf, off)
    except Exception:
        return None
    seg = next((int(e.value[0]) for e in extras
                if e.name == b"seg" and e.nelem == 1), None)
    data = np.fromfile(dpath, np.uint8)
    if seg is None or seg <= 0 or len(data) < anno[-1] \
            or (anno[1:] < anno[:-1]).any() or anno[0] != 0:
        return None
    return tracklen, anno, data[: anno[-1]], seg


def write_qvchk_track(db_path: str, seg: int | None = None,
                      prev_ureads: int | None = None) -> bool:
    """Build + write the track for a committed DB (best-effort).

    With ``prev_ureads`` (the read count before an append) and a valid
    existing track covering exactly those reads, only the appended
    cells are walked and their records appended — append cost is
    proportional to the new cells, like the reference's append
    (dex2DB.c:577-685).  Any mismatch falls back to a full rebuild."""
    from .access import open_db
    from .build import binary_base
    from ..utils.paths import path_to, root as rootof

    db = open_db(db_path)
    base = binary_base(path_to(db_path), rootof(db_path, ".db"))
    n = db.nreads
    if prev_ureads and 0 < prev_ureads < n:
        old = _read_raw_track(base)
        if old is not None:
            tracklen, anno0, data0, seg0 = old
            if tracklen == prev_ureads and (seg is None or seg == seg0):
                part = build_qvchk_track(db, seg0, first=prev_ureads)
                if part is not None:
                    anno = np.concatenate(
                        [anno0[:-1], anno0[-1] + part.anno])
                    data = np.concatenate([data0, part.data])
                    track = Track(name=QVCHK, size=8, nreads=n,
                                  anno=anno, data=data,
                                  extras=part.extras)
                    write_track(base, QVCHK, track)
                    return True
    track = build_qvchk_track(db, seg)
    if track is None:
        return False
    write_track(base, QVCHK, track)
    return True


def load_qvchk(db):
    """Parse the track for this DB object's read window.

    Returns (seg, coffs (n,5) i64, ntoks (n,2), nb (n,) i64,
    ckb (4,B), ckt (2,B), ckc (2,B)) or None when absent/unusable."""
    try:
        if check_track(db, QVCHK) < 0:
            return None
        t = open_track(db, QVCHK)
    except Exception:
        return None
    if t.size != 8 or t.data is None or not t.extras:
        return None
    seg = next((int(e.value[0]) for e in t.extras
                if e.name == b"seg" and e.nelem == 1), None)
    if seg is None or seg <= 0:
        return None
    n = db.nreads
    full = int(db.header["ureads"][0])
    if t.nreads == n:
        base = 0
    elif t.nreads == full:
        base = db.ufirst
    else:
        return None
    anno = t.anno
    words = t.data.view(np.int32)
    sw = (anno[base: base + n + 1] // 4).astype(np.int64)
    if len(sw) != n + 1 or (sw[1:] - sw[:-1] < 8).any() \
            or sw[-1] > len(words):
        return None
    hdr = words[sw[:-1, None] + np.arange(8)]
    coffs = hdr[:, :5].astype(np.int64)
    ntoks = hdr[:, 5:7].astype(np.int64)
    nb = hdr[:, 7].astype(np.int64)
    rlens = db.reads["rlen"].astype(np.int64)
    exp_nb = np.maximum((rlens + seg - 1) // seg - 1, 0)
    seg_ok = (nb == exp_nb).all() and (sw[1:] - sw[:-1] == 8 + 8 * nb).all()
    if not (nb == 0).all() and not seg_ok:
        return None
    btot = int(nb.sum())
    ckb = np.zeros((4, btot), np.int32)
    ckt = np.zeros((2, btot), np.int32)
    ckc = np.full((2, btot), -1, np.int32)
    if btot:
        cko = np.zeros(n + 1, np.int64)
        np.cumsum(nb, out=cko[1:])
        rr = np.flatnonzero(nb)
        for i in rr:                      # long reads only: short loop
            w0 = int(sw[i]) + 8
            k = int(nb[i])
            b0 = int(cko[i])
            blk = words[w0: w0 + 8 * k].reshape(8, k)
            ckb[:, b0:b0 + k] = blk[:4]
            ckt[:, b0:b0 + k] = blk[4:6]
            ckc[:, b0:b0 + k] = blk[6:8]
    return seg, coffs, ntoks, nb, ckb, ckt, ckc
