"""ctypes binding of ``runtime_cc/libstf_runtime.so``; the port's own copy
of the part of ``simple_tensorflow_tpu/runtime/native.py`` that the input
pipeline needs: the load and build (:35-51, ``make -C runtime_cc`` at the
first use), ``crc32c`` (:204), ``read_tfrecord_chunks`` (:216),
``parse_examples_dense`` (:273) and ``parse_examples_ragged`` (:323).

The library is the JAX package's C code, unchanged and shared by both
packages. ``ctypes.CDLL`` releases the GIL for the length of each call,
so reader and parser threads run beside ``Session.run``. Every caller
handles ``available() == False`` (no toolchain, a failed build,
``STF_DISABLE_NATIVE`` set) by taking its Python path. Left out: the
record writer, the arena allocator (the port stages through pinned torch
buffers, ``data/dataset.py``), the graph pruner, the C graph API and the
run-from-C session library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, List, Optional

import numpy as np

from ..platform import sync as _sync

_lock = _sync.Lock("native/lib_load", rank=_sync.RANK_LIFECYCLE,
                   blocking_ok=True)
_lib = None
_tried = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CC_DIR = os.path.join(_REPO_ROOT, "runtime_cc")
_LIB_NAME = "libstf_runtime.so"


def _find_or_build() -> Optional[str]:
    path = os.path.join(_CC_DIR, _LIB_NAME)
    if os.path.exists(path):
        return path
    if os.path.isdir(_CC_DIR):
        try:
            subprocess.run(["make", "-C", _CC_DIR, "-j4"], check=True,
                           capture_output=True, timeout=240)
        except Exception:
            return None
        if os.path.exists(path):
            return path
    return None


def _bind(lib):
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    u64p = c.POINTER(c.c_uint64)
    lib.StfVersion.restype = c.c_char_p
    lib.StfCrc32c.argtypes = [u8p, c.c_size_t]
    lib.StfCrc32c.restype = c.c_uint32
    lib.StfNewStatus.restype = c.c_void_p
    lib.StfDeleteStatus.argtypes = [c.c_void_p]
    lib.StfGetCode.argtypes = [c.c_void_p]
    lib.StfGetCode.restype = c.c_int
    lib.StfMessage.argtypes = [c.c_void_p]
    lib.StfMessage.restype = c.c_char_p
    lib.StfRecordReaderOpen.argtypes = [c.c_char_p, c.c_void_p]
    lib.StfRecordReaderOpen.restype = c.c_void_p
    if hasattr(lib, "StfRecordReaderOpenBuffered"):
        lib.StfRecordReaderOpenBuffered.argtypes = [c.c_char_p, c.c_int64,
                                                    c.c_void_p]
        lib.StfRecordReaderOpenBuffered.restype = c.c_void_p
    lib.StfRecordReaderNextBatch.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(u8p), c.POINTER(u64p), c.c_void_p]
    lib.StfRecordReaderNextBatch.restype = c.c_int64
    lib.StfRecordReaderClose.argtypes = [c.c_void_p]
    lib.StfParseExamplesDense.argtypes = [
        c.POINTER(u8p), c.POINTER(c.c_size_t), c.c_int64,
        c.POINTER(c.c_char_p), c.POINTER(c.c_int32), c.POINTER(c.c_int64),
        c.c_int32, c.POINTER(c.c_void_p), c.POINTER(c.c_uint8), c.c_void_p]
    lib.StfParseExamplesDense.restype = c.c_int
    if hasattr(lib, "StfParseExamplesRagged"):
        lib.StfParseExamplesRagged.argtypes = [
            c.POINTER(u8p), c.POINTER(c.c_size_t), c.c_int64,
            c.POINTER(c.c_char_p), c.POINTER(c.c_int32),
            c.POINTER(c.c_int64), c.c_int32, c.POINTER(c.c_void_p),
            c.POINTER(c.c_int64), c.c_void_p]
        lib.StfParseExamplesRagged.restype = c.c_int
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("STF_DISABLE_NATIVE"):
            return None
        path = _find_or_build()
        if path is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def version() -> str:
    lib = _load()
    return lib.StfVersion().decode() if lib else "unavailable"


class _Status:
    def __init__(self, lib):
        self._lib = lib
        self._h = lib.StfNewStatus()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._lib.StfDeleteStatus(self._h)
        return False

    @property
    def handle(self):
        return self._h

    def check(self):
        code = self._lib.StfGetCode(self._h)
        if code == 0:
            return
        from ..framework import errors

        msg = self._lib.StfMessage(self._h).decode()
        # the C codes are TF's canonical numbering: user-data errors raise
        # the classes the Python paths raise
        try:
            exc = errors.exception_type_from_error_code(code)
        except KeyError:
            raise errors.InternalError(None, None,
                                       f"[native:{code}] {msg}") from None
        raise exc(None, None, msg)


def crc32c(data: bytes) -> int:
    lib = _load()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return lib.StfCrc32c(buf, len(data))


def read_tfrecord_chunks(path: str, batch: int = 256,
                         buffer_size: Optional[int] = None
                         ) -> Iterator[List[bytes]]:
    """The records of ``path`` as lists, one a batched C call (the
    pipeline's shard readers move whole chunks through their rings).
    ``buffer_size`` sets the reader's zlib buffer. Records read before a
    corruption are yielded first, then the error raises."""
    lib = _load()
    with _Status(lib) as st:
        if buffer_size and hasattr(lib, "StfRecordReaderOpenBuffered"):
            h = lib.StfRecordReaderOpenBuffered(
                path.encode(), int(buffer_size), st.handle)
        else:
            h = lib.StfRecordReaderOpen(path.encode(), st.handle)
        st.check()
    try:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        while True:
            buf = u8p()
            offs = u64p()
            # the records and the error leave the status before the yield
            err = None
            with _Status(lib) as st:
                n = lib.StfRecordReaderNextBatch(
                    h, batch, ctypes.byref(buf), ctypes.byref(offs),
                    st.handle)
                try:
                    st.check()
                except Exception as e:
                    err = e
                records = []
                if n > 0:
                    raw = ctypes.string_at(buf, offs[n])
                    records = [raw[offs[i]:offs[i + 1]] for i in range(n)]
            if records:
                yield records
            if err is not None:
                raise err
            if n == 0:
                return
    finally:
        lib.StfRecordReaderClose(h)


def _record_pointers(serialized):
    n = len(serialized)
    bufs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    lens = (ctypes.c_size_t * n)()
    keepalive = []
    for i, s in enumerate(serialized):
        b = bytes(s)
        keepalive.append(b)
        bufs[i] = ctypes.cast(ctypes.c_char_p(b),
                              ctypes.POINTER(ctypes.c_uint8))
        lens[i] = len(b)
    return bufs, lens, keepalive


def parse_examples_dense(serialized, names, kinds, sizes):
    """Parse serialized ``tf.Example`` protos into dense arrays in one C
    call (ref core/util/example_proto_fast_parsing.cc). ``kinds``: 0
    float32, 1 int64 a feature; ``sizes``: its flat element count.
    Returns ``(arrays, missing)``: ``arrays[f]`` ``[n, sizes[f]]``,
    ``missing`` a bool ``[n, n_features]`` mask of absent features."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    n, nf = len(serialized), len(names)
    bufs, lens, _keep = _record_pointers(serialized)
    cnames = (ctypes.c_char_p * nf)(*[x.encode() for x in names])
    ckinds = (ctypes.c_int32 * nf)(*kinds)
    csizes = (ctypes.c_int64 * nf)(*sizes)
    arrays = []
    outs = (ctypes.c_void_p * nf)()
    for f in range(nf):
        a = np.zeros((n, sizes[f]),
                     dtype=np.float32 if kinds[f] == 0 else np.int64)
        arrays.append(a)
        outs[f] = a.ctypes.data_as(ctypes.c_void_p)
    missing = np.zeros((n, nf), dtype=np.uint8)
    with _Status(lib) as st:
        rc = lib.StfParseExamplesDense(
            bufs, lens, n, cnames, ckinds, csizes, nf, outs,
            missing.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            st.handle)
        if rc:
            st.check()
    return arrays, missing.astype(bool)


def ragged_parse_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "StfParseExamplesRagged")


def parse_examples_ragged(serialized, names, kinds, caps, pad_id=-1):
    """Parse varlen ``tf.Example`` features into padded arrays in one C
    call. ``caps``: a feature's padded row width. Returns ``(arrays,
    lengths)``: ``arrays[f]`` ``[n, caps[f]]`` padded with ``pad_id``
    (float features with 0.0); ``lengths`` int64 ``[n, n_features]``, each
    row's true value count (above the cap when the row was truncated;
    the caller clamps and counts)."""
    lib = _load()
    if lib is None or not hasattr(lib, "StfParseExamplesRagged"):
        raise RuntimeError("native ragged parser unavailable")
    n, nf = len(serialized), len(names)
    bufs, lens, _keep = _record_pointers(serialized)
    cnames = (ctypes.c_char_p * nf)(*[x.encode() for x in names])
    ckinds = (ctypes.c_int32 * nf)(*kinds)
    ccaps = (ctypes.c_int64 * nf)(*caps)
    arrays = []
    outs = (ctypes.c_void_p * nf)()
    for f in range(nf):
        if kinds[f] == 0:
            a = np.zeros((n, caps[f]), dtype=np.float32)
        else:
            a = np.full((n, caps[f]), pad_id, dtype=np.int64)
        arrays.append(a)
        outs[f] = a.ctypes.data_as(ctypes.c_void_p)
    lengths = np.zeros((n, nf), dtype=np.int64)
    with _Status(lib) as st:
        rc = lib.StfParseExamplesRagged(
            bufs, lens, n, cnames, ckinds, ccaps, nf, outs,
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            st.handle)
        if rc:
            st.check()
    return arrays, lengths
