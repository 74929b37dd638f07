"""ctypes binding for the C++ native I/O module (libpisces_io.so).

The library is built from the sources beside it on first use, and built
again whenever a hash of those sources and the Makefile differs from the
hash stamped beside the library. If it cannot be built, a warning is
logged and callers fall back to the pure-Python reader.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpisces_io.so")
_STAMP_PATH = _LIB_PATH + ".srchash"
_lib: Optional[ctypes.CDLL] = None


def source_hash() -> str:
    """sha256 over the native .cpp sources and the Makefile."""
    h = hashlib.sha256()
    paths = sorted(glob.glob(os.path.join(_NATIVE_DIR, "*.cpp")))
    for path in paths + [os.path.join(_NATIVE_DIR, "Makefile")]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()


def _is_current(want: str) -> bool:
    try:
        with open(_STAMP_PATH) as f:
            stamped = f.read().strip()
    except OSError:
        return False
    return stamped == want and os.path.exists(_LIB_PATH)


def build(force: bool = False) -> bool:
    """Make libpisces_io.so unless it was built from the current sources.
    Concurrent callers (test workers, worker processes) serialize on a lock
    file, so one builds and the rest load its result."""
    import fcntl

    from pisces_tpu.utils.logger import log
    want = source_hash()
    if not force and _is_current(want):
        return True
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _is_current(want):
            return True
        try:
            # -B: the stamp, not file times, decides that a build is due
            subprocess.run(["make", "-B", "-C", _NATIVE_DIR,
                            "libpisces_io.so"], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            err = getattr(e, "stderr", b"") or b""
            log(f"native library build failed ({e}: "
                f"{err.decode(errors='replace')[-500:]}); falling back to "
                f"the Python reader", "WARNING")
            return False
        with open(_STAMP_PATH + ".tmp", "w") as f:
            f.write(want + "\n")
        os.replace(_STAMP_PATH + ".tmp", _STAMP_PATH)
    return os.path.exists(_LIB_PATH)


def library_info() -> dict:
    """Path of the loaded library and the source hash it was built from."""
    return {"path": _LIB_PATH, "source_hash": source_hash()}


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.bam_open.restype = ctypes.c_void_p
    lib.bam_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bam_close.argtypes = [ctypes.c_void_p]
    lib.bam_n_refs.argtypes = [ctypes.c_void_p]
    lib.bam_ref_name.restype = ctypes.c_char_p
    lib.bam_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_n_records.restype = ctypes.c_int64
    lib.bam_n_records.argtypes = [ctypes.c_void_p]
    lib.bam_header_text.restype = ctypes.c_void_p
    lib.bam_header_text.argtypes = [ctypes.c_void_p]
    lib.bam_header_text_len.restype = ctypes.c_int64
    lib.bam_header_text_len.argtypes = [ctypes.c_void_p]
    lib.bam_decode.restype = ctypes.c_int64
    lib.bam_decode.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name, ct in [("bam_col_ref_id", ctypes.c_int32),
                     ("bam_col_pos", ctypes.c_int32),
                     ("bam_col_end_pos", ctypes.c_int32),
                     ("bam_col_mapq", ctypes.c_uint8),
                     ("bam_col_flag", ctypes.c_uint16),
                     ("bam_col_cigar_off", ctypes.c_int64),
                     ("bam_col_cigar_ops", ctypes.c_uint8),
                     ("bam_col_cigar_lens", ctypes.c_int32),
                     ("bam_col_seq_off", ctypes.c_int64),
                     ("bam_col_seq", ctypes.c_int8),
                     ("bam_col_qual", ctypes.c_uint8),
                     ("bam_col_mate_ref_id", ctypes.c_int32),
                     ("bam_col_mate_pos", ctypes.c_int32),
                     ("bam_col_name_off", ctypes.c_int64)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.bam_col_name_blob.restype = ctypes.c_void_p
    lib.bam_col_name_blob.argtypes = [ctypes.c_void_p]
    lib.bam_total_cigar.restype = ctypes.c_int64
    lib.bam_total_cigar.argtypes = [ctypes.c_void_p]
    lib.bam_total_bases.restype = ctypes.c_int64
    lib.bam_total_bases.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _bind_lazy(lib) -> None:
    if getattr(lib, "_lazy_bound", False):
        return
    lib.bam_open_lazy.restype = ctypes.c_void_p
    lib.bam_open_lazy.argtypes = [ctypes.c_char_p]
    lib.bam_fetch_region.restype = ctypes.c_int64
    lib.bam_fetch_region.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64]
    lib._lazy_bound = True


def _bind_tags(lib) -> None:
    """Bind the typed-tag decode exports (TagUtils analog columns)."""
    if getattr(lib, "_tags_bound", False):
        return
    lib.bam_decode_tags.restype = ctypes.c_int64
    lib.bam_decode_tags.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.bam_col_tag_blob.restype = ctypes.c_void_p
    lib.bam_col_tag_blob.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bam_col_tag_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.bam_col_tag_off.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for name, ct in [("bam_col_xv_val", ctypes.c_int32),
                     ("bam_col_xw_val", ctypes.c_int32),
                     ("bam_col_tag_present", ctypes.c_uint8)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib._tags_bound = True


def _as_array(ptr, n, dtype):
    """Copy a C buffer into a fresh ndarray with one memcpy.

    The requested dtype must have the same itemsize as the pointer's
    element type (guaranteed by the matching restype declarations)."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    out = np.empty(n, dtype=dtype)
    ctypes.memmove(out.ctypes.data, ctypes.addressof(ptr.contents), out.nbytes)
    return out


def _as_view(ptr, n, dtype):
    """Zero-copy read-only ndarray view over a C buffer.

    No pages are touched and nothing is allocated — essential on hosts
    where page faults are kernel-bypass-expensive (sandboxed VMs: ~0.1 ms
    per faulted page makes a 60 MB copy cost seconds). The view is valid
    until the owning handle's next producing call (bam_decode /
    bam_pileup*) or bam_close; callers consume it before either."""
    if n == 0:
        return np.empty(0, dtype=dtype)
    dtype = np.dtype(dtype)
    buf = (ctypes.c_char * (n * dtype.itemsize)).from_address(
        ctypes.addressof(ptr.contents))
    arr = np.frombuffer(buf, dtype=dtype, count=n)
    arr.flags.writeable = False
    return arr


class NativeBamReader:
    """Native counterpart of io.bam.BamReader with the same fetch() contract.

    lazy=True keeps the file compressed and serves fetch_region() through
    the .bai index, inflating only the touched BGZF blocks per window (the
    BamReader.Jump analog, Alignment.IO/BamReader.cs:22-677) — the
    bounded-memory WGS streaming mode."""

    def __init__(self, path: str, n_threads: int = 0, lazy: bool = False):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        self._lazy = lazy
        self._bai = None
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 16)
        if lazy:
            _bind_lazy(lib)
            self._h = lib.bam_open_lazy(path.encode())
        else:
            self._h = lib.bam_open(path.encode(), n_threads)
        if not self._h:
            raise IOError(f"failed to open {path}")
        from pisces_tpu.io.bam import BamHeader
        n_refs = lib.bam_n_refs(self._h)
        names = [lib.bam_ref_name(self._h, i).decode() for i in range(n_refs)]
        lens = [lib.bam_ref_len(self._h, i) for i in range(n_refs)]
        tlen = lib.bam_header_text_len(self._h)
        text = ctypes.string_at(lib.bam_header_text(self._h), tlen).decode(
            "utf-8", errors="replace")
        self.header = BamHeader(text, names, lens)
        self.path = path

    @property
    def n_records(self) -> int:
        return int(self._lib.bam_n_records(self._h))

    def _fetch_impl(self, ref_id: Optional[int] = None,
                    parse_names: bool = False, parse_tags: bool = False,
                    as_views: bool = False):
        """as_views=True serves the base-sized columns (seq/qual/cigar) as
        zero-copy views into the handle's decode buffers — valid until the
        next bam_decode/bam_fetch_region on this handle (bam_pileup_mm only
        clears its own result vectors, so pileup does NOT invalidate them).
        Only the single-pass caller path opts in; batch-retaining consumers
        (scylla neighborhoods, gemini) keep copies."""
        from pisces_tpu.io.bam import ReadBatch
        lib = self._lib
        _bind_tags(lib)
        n = int(lib.bam_decode_tags(self._h,
                                    -1 if ref_id is None else ref_id,
                                    1 if parse_tags else 0))
        total_cigar = int(lib.bam_total_cigar(self._h))
        total_bases = int(lib.bam_total_bases(self._h))
        big = _as_view if as_views else _as_array
        names = None
        if parse_names and n:
            name_off = _as_array(lib.bam_col_name_off(self._h), n + 1,
                                 np.int64)
            blob = ctypes.string_at(lib.bam_col_name_blob(self._h),
                                    int(name_off[-1]))
            names = [blob[name_off[i]:name_off[i + 1]].decode(
                "ascii", errors="replace") for i in range(n)]
        elif parse_names:
            names = []
        xd_tags = xn_tags = extra_tags = None
        if parse_tags:
            xd_tags, xn_tags, extra_tags = self._build_tag_lists(n)
        return ReadBatch(
            n=n,
            ref_id=_as_array(lib.bam_col_ref_id(self._h), n, np.int32),
            pos=_as_array(lib.bam_col_pos(self._h), n, np.int32),
            mapq=_as_array(lib.bam_col_mapq(self._h), n, np.uint8),
            flag=_as_array(lib.bam_col_flag(self._h), n, np.uint16),
            cigar_off=_as_array(lib.bam_col_cigar_off(self._h), n + 1, np.int64),
            cigar_ops=big(lib.bam_col_cigar_ops(self._h), total_cigar,
                          np.uint8),
            cigar_lens=big(lib.bam_col_cigar_lens(self._h), total_cigar,
                           np.int32),
            seq_off=_as_array(lib.bam_col_seq_off(self._h), n + 1, np.int64),
            seq=big(lib.bam_col_seq(self._h), total_bases, np.int8),
            qual=big(lib.bam_col_qual(self._h), total_bases, np.uint8),
            end_pos=_as_array(lib.bam_col_end_pos(self._h), n, np.int32),
            xd_tags=xd_tags,
            xn_tags=xn_tags,
            extra_tags=extra_tags,
            names=names,
            mate_ref_id=_as_array(lib.bam_col_mate_ref_id(self._h), n,
                                  np.int32),
            mate_pos=_as_array(lib.bam_col_mate_pos(self._h), n, np.int32),
        )

    def _build_tag_lists(self, n: int):
        """Materialize xd/xn/extra tag lists from the native tag columns
        (same contract as the Python reader's _parse_string_tags)."""
        lib = self._lib
        if n == 0:
            return [], [], []
        present = _as_array(lib.bam_col_tag_present(self._h), n, np.uint8)
        names = ("xd", "xn", "xr", "xu", "xw_s")
        offs = {}
        blobs = {}
        for slot, name in enumerate(names):
            o = _as_array(lib.bam_col_tag_off(self._h, slot), n + 1, np.int64)
            offs[name] = o
            blobs[name] = (ctypes.string_at(
                lib.bam_col_tag_blob(self._h, slot), int(o[-1]))
                if o[-1] else b"")
        xv = _as_array(lib.bam_col_xv_val(self._h), n, np.int32)
        xw = _as_array(lib.bam_col_xw_val(self._h), n, np.int32)

        def s(name, i):
            o = offs[name]
            return blobs[name][o[i]:o[i + 1]].decode("ascii",
                                                     errors="replace")

        xd_tags, xn_tags, extra = [], [], []
        pres = present.tolist()
        for i in range(n):
            p = pres[i]
            tags = {}
            xd = s("xd", i) if p & 1 else None
            xn = s("xn", i) if p & 2 else None
            if xd is not None:
                tags["XD"] = xd
            if xn is not None:
                tags["XN"] = xn
            if p & 4:
                tags["XR"] = s("xr", i)
            if p & 8:
                tags["XU"] = s("xu", i)
            if p & 16:
                tags["XV"] = int(xv[i])
            if p & 32:
                tags["XW"] = int(xw[i])
            if p & 64:  # Z-typed XW overrides an int XW (parser order)
                tags["XW"] = s("xw_s", i)
            xd_tags.append(xd)
            xn_tags.append(xn)
            extra.append(tags)
        return xd_tags, xn_tags, extra

    supports_view_fetch = True  # capability flag for as_views callers

    def fetch(self, ref_id: Optional[int] = None, parse_names: bool = False,
              parse_tags: bool = False, as_views: bool = False):
        batch = self._fetch_impl(ref_id, parse_names, parse_tags, as_views)
        batch._from_native_handle = True
        return batch

    def fetch_region(self, ref_id: int, beg0: int, end0: int,
                     parse_tags: bool = False, parse_names: bool = False,
                     as_views: bool = False):
        """Reads overlapping [beg0, end0) (0-based half-open) via the .bai
        index: only the indexed BGZF chunks inflate, and the overlap filter
        runs in C++ so the handle's decoded state stays 1:1 with the batch
        (native pileup depends on that)."""
        if not self._lazy:
            from pisces_tpu.io.bam import subset_batch
            # subset_batch copies, so views are safe to source from here
            batch = self.fetch(ref_id, parse_names, parse_tags)
            mask = (batch.pos < end0) & (batch.end_pos >= beg0)
            return subset_batch(batch, mask)
        if self._bai is None:
            from pisces_tpu.io import bai
            p = self.path + ".bai"
            self._bai = bai.read_bai(p) if os.path.exists(p) else False
        if self._bai is False:
            raise IOError(f"{self.path}: lazy region fetch needs a .bai")
        chunks = self._bai.query(ref_id, beg0, end0)
        begs = np.ascontiguousarray(
            np.array([c[0] for c in chunks], dtype=np.uint64))
        ends = np.ascontiguousarray(
            np.array([c[1] for c in chunks], dtype=np.uint64))
        lib = self._lib
        n = lib.bam_fetch_region(
            self._h, ref_id, beg0, end0,
            begs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(chunks))
        if n < 0:
            raise IOError(f"{self.path}: native region fetch failed")
        batch = self._fetch_impl(ref_id, parse_names, parse_tags, as_views)
        batch._from_native_handle = True
        return batch

    def close(self):
        if self._h:
            self._lib.bam_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_bam(path: str, prefer_native: bool = True, lazy: bool = False):
    """Open a BAM with the native reader when available, else Python."""
    if prefer_native and get_lib() is not None:
        try:
            return NativeBamReader(path, lazy=lazy)
        except (IOError, RuntimeError):
            pass
    from pisces_tpu.io.bam import BamReader
    return BamReader(path, lazy=lazy)


def _bind_pileup(lib):
    if hasattr(lib, "_pileup_bound"):
        return
    lib.bam_pileup.restype = ctypes.c_int64
    lib.bam_pileup.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int8)]
    lib.bam_pileup_mm.restype = ctypes.c_int64
    lib.bam_pileup_mm.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int]
    lib.pileup_n_mismatches.restype = ctypes.c_int64
    lib.pileup_n_mismatches.argtypes = [ctypes.c_void_p]
    for name, ct in [("pileup_mm_gpos", ctypes.c_int64),
                     ("pileup_mm_alt", ctypes.c_int8),
                     ("pileup_mm_dir", ctypes.c_int8),
                     ("pileup_mm_flags", ctypes.c_int8)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    for name, ct in [("pileup_block_keys", ctypes.c_int64),
                     ("pileup_counts_t", ctypes.c_int32),
                     ("pileup_qual_t", ctypes.c_double),
                     ("pileup_anchored_counts", ctypes.c_int32),
                     ("pileup_anchored_quals", ctypes.c_double),
                     ("pileup_pos_tuples", ctypes.c_int32)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib.pileup_has_pos_tuples.restype = ctypes.c_int64
    lib.pileup_has_pos_tuples.argtypes = [ctypes.c_void_p]
    lib.pileup_gvcf_unique.restype = ctypes.c_int64
    lib.pileup_gvcf_unique.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int64]
    lib.pileup_n_uniq.restype = ctypes.c_int64
    lib.pileup_n_uniq.argtypes = [ctypes.c_void_p]
    for name, ct in [("pileup_sel_positions", ctypes.c_int64),
                     ("pileup_uniq_tuples", ctypes.c_int32),
                     ("pileup_uniq_inv", ctypes.c_int32)]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ct)
        fn.argtypes = [ctypes.c_void_p]
    lib._pileup_bound = True


def native_pileup(reader: "NativeBamReader", keep: np.ndarray, min_bq: int,
                  anchor_size: int, block_size: int,
                  anchored_positions: Optional[np.ndarray] = None,
                  base_dirs: Optional[np.ndarray] = None,
                  ref_codes: Optional[np.ndarray] = None,
                  track_open_ended: bool = True):
    """Run the C++ pileup accumulation over the reader's decoded batch.
    Returns (PileupCounts, mismatches) where mismatches is None unless
    ref_codes is given, else (gpos, alt, dir, flags) event arrays for SNV
    candidate aggregation."""
    from pisces_tpu.pileup.counts import PileupCounts
    from pisces_tpu.domain.types import (
        NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, num_anchor_indexes,
    )
    lib = reader._lib
    _bind_pileup(lib)
    keep_u8 = np.ascontiguousarray(keep.astype(np.uint8))
    if anchored_positions is None or len(anchored_positions) == 0:
        ap = np.empty(0, dtype=np.int64)
    else:
        ap = np.unique(np.asarray(anchored_positions, dtype=np.int64))
    ap_c = np.ascontiguousarray(ap)
    rc = (np.ascontiguousarray(ref_codes, dtype=np.int8)
          if ref_codes is not None else None)
    nb = lib.bam_pileup_mm(
        reader._h, keep_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        min_bq, anchor_size, block_size,
        ap_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(ap_c),
        (base_dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
         if base_dirs is not None else None),
        (rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
         if rc is not None else None),
        0 if rc is None else len(rc), 1 if track_open_ended else 0)
    k = num_anchor_indexes(anchor_size)
    shape_t = (nb, block_size, NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES)
    block_keys = _as_array(lib.pileup_block_keys(reader._h), nb, np.int64)
    n_t = nb * block_size * 18
    # zero-copy views: the dense tensors are tens of MB and consumed before
    # the handle's next pileup call; copying them costs seconds on
    # fault-expensive hosts (see _as_view)
    counts_t = _as_view(lib.pileup_counts_t(reader._h), n_t,
                        np.int32).reshape(shape_t)
    qual_t = _as_view(lib.pileup_qual_t(reader._h), n_t,
                      np.float64).reshape(shape_t)
    n_a = len(ap_c) * 18 * k
    ac = _as_array(lib.pileup_anchored_counts(reader._h), n_a, np.int32)\
        .reshape(len(ap_c), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)
    aq = _as_array(lib.pileup_anchored_quals(reader._h), n_a, np.float64)\
        .reshape(len(ap_c), NUM_ALLELE_TYPES, NUM_DIRECTION_TYPES, k)
    pc = PileupCounts(block_keys, block_size, anchor_size, counts_t, qual_t,
                      ap_c, ac, aq)
    if lib.pileup_has_pos_tuples(reader._h):
        pc.pos_tuples = _as_view(lib.pileup_pos_tuples(reader._h),
                                 nb * block_size * 8,
                                 np.int32).reshape(nb * block_size, 8)
        # C++ dedup of covered loci to unique scoring tuples (the fast-gVCF
        # reduction; fast_gvcf skips its Python np.unique when present)
        n_sel = lib.pileup_gvcf_unique(reader._h, block_size, len(rc))
        if n_sel >= 0:
            u = int(lib.pileup_n_uniq(reader._h))
            # zero-copy views (like counts_t above): these are the largest
            # per-window arrays (~24 B/locus) and every consumer finishes
            # with them before the handle's next pileup call — write_spliced
            # runs per window, before the next window's fetch/pileup
            pc.gvcf_unique = (
                _as_view(lib.pileup_sel_positions(reader._h), n_sel,
                         np.int64),
                _as_view(lib.pileup_uniq_tuples(reader._h), u * 6,
                         np.int32).reshape(u, 6).astype(np.int64),
                _as_view(lib.pileup_uniq_inv(reader._h), n_sel, np.int32))
    mismatches = None
    if ref_codes is not None:
        n_mm = int(lib.pileup_n_mismatches(reader._h))
        # views: consumed by candidate aggregation inside call_chromosome,
        # before any further native call on this handle
        mismatches = (
            _as_view(lib.pileup_mm_gpos(reader._h), n_mm, np.int64),
            _as_view(lib.pileup_mm_alt(reader._h), n_mm, np.int8),
            _as_view(lib.pileup_mm_dir(reader._h), n_mm, np.int8),
            _as_view(lib.pileup_mm_flags(reader._h), n_mm, np.int8))
    return pc, mismatches


# ---------------------------------------------------------------------------
# Parallel BGZF compression (BamWriterMultithreaded counterpart)
# ---------------------------------------------------------------------------

def _bind_render(lib) -> None:
    if getattr(lib, "_render_bound", False):
        return
    lib.render_ref_lines.restype = ctypes.c_void_p
    lib.render_ref_lines.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64)]
    lib.rl_blob_len.restype = ctypes.c_int64
    lib.rl_blob_len.argtypes = [ctypes.c_void_p]
    lib.rl_blob.restype = ctypes.c_void_p
    lib.rl_blob.argtypes = [ctypes.c_void_p]
    lib.rl_line_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.rl_line_off.argtypes = [ctypes.c_void_p]
    lib.rl_free.argtypes = [ctypes.c_void_p]
    lib._render_bound = True


class _RenderedBlobOwner:
    """Owns a render_ref_lines C++ result: exposes the blob as a zero-copy
    memoryview; frees the native buffer when the last Python reference
    (including every RefLineBlock slice sharing it) is dropped."""

    __slots__ = ("_lib", "_h", "mv", "off")

    def __init__(self, lib, h, n: int):
        self._lib = lib
        self._h = h
        blob_len = lib.rl_blob_len(h)
        buf = (ctypes.c_char * blob_len).from_address(lib.rl_blob(h))
        self.mv = memoryview(buf).cast("B")
        # offsets are copied (small) so they outlive nothing native
        self.off = np.array(_as_array(lib.rl_line_off(h), n + 1, np.int64))

    def __del__(self):
        try:
            self.mv.release()
        except BufferError:
            # an exported sub-view of the blob still lives: freeing the
            # native buffer now would be a use-after-free under that view.
            # Leak it instead — strictly safer, and unreachable for in-repo
            # consumers (RefLineBlock always holds the owner).
            return
        except Exception:
            pass
        self._lib.rl_free(self._h)


def render_reference_lines(prefix: str, positions: np.ndarray,
                           inv: np.ndarray, bases: np.ndarray,
                           tails: list):
    """C++ rendering of per-locus gVCF reference lines: one blob + [n+1]
    line offsets (fast_gvcf.format_reference_lines hot tail). Returns
    (blob_memoryview, offsets, owner) — zero-copy into the C++ buffer,
    which lives until `owner` is garbage-collected — or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_render(lib)
    n = len(positions)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    inv_c = np.ascontiguousarray(inv, dtype=np.int32)
    bases_c = np.ascontiguousarray(bases, dtype=np.uint8)
    tail_bytes = [t.encode("latin-1") for t in tails]
    tails_blob = b"".join(tail_bytes)
    tail_off = np.zeros(len(tails) + 1, np.int64)
    np.cumsum([len(t) for t in tail_bytes], out=tail_off[1:])
    tail_off_c = np.ascontiguousarray(tail_off)
    p = prefix.encode("latin-1")
    h = lib.render_ref_lines(
        p, len(p), n, pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inv_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bases_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tails_blob, tail_off_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    owner = _RenderedBlobOwner(lib, h, n)
    return owner.mv, owner.off, owner


def _bind_bgzfc(lib) -> None:
    if getattr(lib, "_bgzfc_bound", False):
        return
    lib.bgzf_compress.restype = ctypes.c_void_p
    lib.bgzf_compress.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.bgzfc_data_len.restype = ctypes.c_int64
    lib.bgzfc_data_len.argtypes = [ctypes.c_void_p]
    lib.bgzfc_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.bgzfc_data.argtypes = [ctypes.c_void_p]
    lib.bgzfc_n_blocks.restype = ctypes.c_int64
    lib.bgzfc_n_blocks.argtypes = [ctypes.c_void_p]
    lib.bgzfc_block_off.restype = ctypes.POINTER(ctypes.c_int64)
    lib.bgzfc_block_off.argtypes = [ctypes.c_void_p]
    lib.bgzfc_free.argtypes = [ctypes.c_void_p]
    lib._bgzfc_bound = True


def bgzf_compress_parallel(data, level: int = 6, n_threads: int = 0):
    """Compress a byte buffer into BGZF (fixed 0xFF00-byte uncompressed
    chunks + EOF block) across threads. Returns (compressed_bytes,
    block_file_offsets[int64]) where block i holds uncompressed bytes
    [i*0xFF00, (i+1)*0xFF00); a record starting at uncompressed offset u has
    virtual offset (block_file_offsets[u // 0xFF00] << 16) | (u % 0xFF00).
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _bind_bgzfc(lib)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    buf = np.frombuffer(data, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    h = lib.bgzf_compress(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          len(buf), level, n_threads)
    if not h:
        return None
    try:
        nb = lib.bgzfc_n_blocks(h)
        out = _as_array(lib.bgzfc_data(h), lib.bgzfc_data_len(h),
                        np.uint8).tobytes()
        offs = _as_array(lib.bgzfc_block_off(h), nb + 1, np.int64)
    finally:
        lib.bgzfc_free(h)
    return out, offs
