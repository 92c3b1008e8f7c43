"""PacBio .bax.h5 reader (reference bax.c:47-600).

Bulk-loads whole datasets through the native HDF5 shim (there is no h5py in
this environment), then iterates subreads from the region tables with the
reference's exact stateful semantics (nextSubread, bax.c:431-530):

- wells are the consecutive hole numbers starting at regions[0].HOLE;
- per hole, the HQ region supplies the clip window [hbeg, hend) and the
  read quality; holes with no positive HQ score or holeType > 0 yield none;
- INSERT regions clipped to the HQ window become subreads;
- delLimit = the DeletionQV under the first 'N' DeletionTag (bax.c:245-253);
- channel order comes from the DyeSet BaseMap attribute (bax.c:218-237).

The port's own copy of ``dextractor_tpu/ingest/bax.py``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..utils.errors import DextractorError

# region table columns (bax.c:279-286)
HOLE, TYPE, START, FINISH, SCORE = range(5)
ADAPTER_REGION, INSERT_REGION, HQV_REGION = 0, 1, 2

_DNA2NUM = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _DNA2NUM[_c] = _i
    _DNA2NUM[_c + 32] = _i


@dataclass
class SubRead:
    well: int
    fpulse: int
    lpulse: int
    qv: int
    data_off: int
    zmw_off: int


@dataclass
class BaxData:
    movie_name: bytes
    base_call: np.ndarray          # (numBP,) u8 ascii
    pulse_w: np.ndarray | None     # (numBP,) u16
    del_qv: np.ndarray | None      # raw (pre-Phred) u8
    del_tag: np.ndarray | None
    ins_qv: np.ndarray | None
    merge_qv: np.ndarray | None
    sub_qv: np.ndarray | None
    hole_type: np.ndarray          # (numZMW,) u8
    read_len: np.ndarray           # (numZMW,) i32
    snr_vec: np.ndarray | None     # (numZMW, 4) f32
    chan: np.ndarray | None        # (4,) channel permutation
    regions: np.ndarray            # (numHQR, 5) i32
    del_limit: int = -1

    def subreads(self):
        """Iterate subreads with nextSubread's semantics (bax.c:431-530)."""
        regions = self.regions
        if len(regions) == 0:
            return
        n_zmw = len(self.read_len)
        first_hole = int(regions[0, HOLE])
        holes = regions[:, HOLE]

        # group region rows by hole (rows for one hole are contiguous)
        roff = 0
        ridx = 0
        n_rows = len(regions)
        for w in range(n_zmw):
            h = first_hole + w
            while ridx < n_rows and holes[ridx] < h:
                ridx += 1
            bot = ridx
            hqv = bot
            while ridx < n_rows and holes[ridx] == h:
                if regions[ridx, TYPE] == HQV_REGION:
                    hqv = ridx
                ridx += 1
            top = ridx

            qv = int(regions[hqv, SCORE]) if hqv < n_rows else 0
            if bot < top and qv > 0 and self.hole_type[w] == 0:
                hbeg = int(regions[hqv, START])
                hend = int(regions[hqv, FINISH])
                for r in range(bot, top):
                    if regions[r, TYPE] != INSERT_REGION:
                        continue
                    ibeg = max(int(regions[r, START]), hbeg)
                    iend = min(int(regions[r, FINISH]), hend)
                    if iend - ibeg <= 0:
                        continue
                    yield SubRead(well=h, fpulse=ibeg, lpulse=iend, qv=qv,
                                  data_off=roff, zmw_off=w)
            roff += int(self.read_len[w])


def _read_vec(shim, f, path: bytes, code: int, dtype, expect=None) -> np.ndarray:
    dims = (ctypes.c_longlong * 8)()
    rank = shim.dxt_h5_dataset_dims(f, path, dims, 8)
    if rank < 0:
        raise DextractorError(f"missing dataset {path.decode()} in bax file")
    shape = tuple(dims[i] for i in range(rank))
    if expect is not None and shape[0] != expect:
        raise DextractorError(f"dataset {path.decode()} has unexpected length")
    buf = np.empty(shape, dtype)
    if buf.size and shim.dxt_h5_read(
            f, path, code, buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise DextractorError(f"could not read dataset {path.decode()}")
    return buf


def read_bax(path: str, quivqv: bool = False, arrow: bool = False) -> BaxData:
    from ..native import hdf5_shim

    try:
        shim = hdf5_shim()
    except OSError as e:
        raise DextractorError(f"HDF5 support unavailable: {e}")

    f = shim.dxt_h5_open(path.encode())
    if f < 0:
        raise DextractorError("Cannot open bax file")
    try:
        name = ctypes.create_string_buffer(65536)
        n = shim.dxt_h5_attr_str(f, b"/ScanData/RunInfo", b"MovieName",
                                 name, 65536)
        if n < 0:
            raise DextractorError("Cannot fetch movie name")
        movie = name.value

        base = _read_vec(shim, f, b"/PulseData/BaseCalls/Basecall", 0, np.uint8)
        num_bp = len(base)
        pulse_w = del_qv = del_tag = ins_qv = merge_qv = sub_qv = None
        if arrow:
            pulse_w = _read_vec(shim, f, b"/PulseData/BaseCalls/WidthInFrames",
                                1, np.uint16, num_bp)
        if quivqv:
            del_qv = _read_vec(shim, f, b"/PulseData/BaseCalls/DeletionQV",
                               0, np.uint8, num_bp)
            del_tag = _read_vec(shim, f, b"/PulseData/BaseCalls/DeletionTag",
                                0, np.uint8, num_bp)
            ins_qv = _read_vec(shim, f, b"/PulseData/BaseCalls/InsertionQV",
                               0, np.uint8, num_bp)
            merge_qv = _read_vec(shim, f, b"/PulseData/BaseCalls/MergeQV",
                                 0, np.uint8, num_bp)
            sub_qv = _read_vec(shim, f, b"/PulseData/BaseCalls/SubstitutionQV",
                               0, np.uint8, num_bp)

        hole_type = _read_vec(shim, f, b"/PulseData/BaseCalls/ZMW/HoleStatus",
                              0, np.uint8)
        n_zmw = len(hole_type)
        read_len = _read_vec(shim, f, b"/PulseData/BaseCalls/ZMW/NumEvent",
                             2, np.int32, n_zmw)
        snr_vec = chan = None
        if arrow:
            snr_vec = _read_vec(
                shim, f, b"/PulseData/BaseCalls/ZMWMetrics/HQRegionSNR",
                3, np.float32, n_zmw).reshape(n_zmw, 4)
            bm = ctypes.create_string_buffer(64)
            if shim.dxt_h5_attr_str(f, b"/ScanData/DyeSet", b"BaseMap",
                                    bm, 64) < 0:
                raise DextractorError("Cannot fetch BaseMap")
            chan = _DNA2NUM[np.frombuffer(bm.value[:4], np.uint8)].astype(np.int64)

        regions = _read_vec(shim, f, b"/PulseData/Regions", 2, np.int32)
        regions = regions.reshape(-1, 5)

        del_limit = -1
        if quivqv:
            hits = np.flatnonzero(del_tag == ord("N"))
            if len(hits):
                del_limit = int(del_qv[hits[0]])

        return BaxData(
            movie_name=movie, base_call=base, pulse_w=pulse_w,
            del_qv=del_qv, del_tag=del_tag, ins_qv=ins_qv,
            merge_qv=merge_qv, sub_qv=sub_qv, hole_type=hole_type,
            read_len=read_len, snr_vec=snr_vec, chan=chan,
            regions=regions, del_limit=del_limit)
    finally:
        shim.dxt_h5_close(f)


# ------------------------------------------------------------------
# fixture writer (tests only; the environment has no h5py)
# ------------------------------------------------------------------

def write_bax(path: str, movie: bytes, base_call: np.ndarray,
              read_len: np.ndarray, hole_type: np.ndarray,
              regions: np.ndarray, pulse_w=None, snr=None, basemap=b"ACGT",
              qv_streams=None) -> None:
    from ..native import hdf5_shim

    shim = hdf5_shim()
    f = shim.dxt_h5_create(path.encode())
    if f < 0:
        raise OSError(f"cannot create {path}")

    def w1(p, code, arr):
        arr = np.ascontiguousarray(arr)
        dims = (ctypes.c_longlong * arr.ndim)(*arr.shape)
        if shim.dxt_h5_write(f, p, code, arr.ctypes.data_as(ctypes.c_void_p),
                             dims, arr.ndim) != 0:
            raise OSError(f"cannot write {p}")

    shim.dxt_h5_attr_str_write(f, b"/ScanData/RunInfo", b"MovieName", movie)
    w1(b"/PulseData/BaseCalls/Basecall", 0, base_call.astype(np.uint8))
    w1(b"/PulseData/BaseCalls/ZMW/HoleStatus", 0, hole_type.astype(np.uint8))
    w1(b"/PulseData/BaseCalls/ZMW/NumEvent", 2, read_len.astype(np.int32))
    w1(b"/PulseData/Regions", 2, regions.astype(np.int32))
    if pulse_w is not None:
        w1(b"/PulseData/BaseCalls/WidthInFrames", 1, pulse_w.astype(np.uint16))
    if snr is not None:
        w1(b"/PulseData/BaseCalls/ZMWMetrics/HQRegionSNR", 3,
           snr.astype(np.float32))
        shim.dxt_h5_attr_str_write(f, b"/ScanData/DyeSet", b"BaseMap", basemap)
    if qv_streams is not None:
        names = (b"DeletionQV", b"DeletionTag", b"InsertionQV", b"MergeQV",
                 b"SubstitutionQV")
        for nm, arr in zip(names, qv_streams):
            w1(b"/PulseData/BaseCalls/" + nm, 0, np.asarray(arr, np.uint8))
    shim.dxt_h5_close(f)
