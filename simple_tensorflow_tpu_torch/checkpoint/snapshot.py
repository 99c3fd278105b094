"""The stf-bundle checkpoint format, native unsharded path; the port of
``simple_tensorflow_tpu/checkpoint/snapshot.py`` (``encode_npz`` :262,
``build_index_doc`` :271, ``write_native_checkpoint`` :283,
``read_index`` :309, ``verify_checkpoint`` :314).

Format (the JAX package's ``docs/CHECKPOINT.md``): ``<prefix>.stfz``, an
npz of every tensor with ``/`` in keys written ``|``, beside
``<prefix>.index.json`` (dtypes, shapes, the data file's sha256 and size,
the host state) and the ``checkpoint`` state file. Data, then index, then
state file, each through the atomic temp + fsync + replace commit
(``atomic.py``), so a crash at any point leaves the previous checkpoint
loadable.

bfloat16: the JAX saver writes a bf16 tensor through numpy's ``bfloat16``
(``ml_dtypes``), whose ``.npy`` header says ``'<V2'`` over the raw 2-byte
values, and names it ``"bfloat16"`` in the index. The port writes the same
header over the same bits without ``ml_dtypes`` (:func:`host_array`,
:func:`encode_npz`) and reads such an entry back as raw bits
(:func:`tensor_from_entry`), so either package restores the other's file.

Barrier snapshots (the JAX package's ``TrainingStateSnapshot`` :69 and
``capture_training_state`` :137), for the async plane: a device copy of
the named store entries, made on the stream that ran the last step, after
it and before the next one (no host sync; an event recorded after it),
plus the host state at the same point. A flat optimizer group whose
views are among the entries is copied once, in one ``copy_``, and the
snapshot hands out views of that copy (``Session.snapshot_device_state``).
The writer thread waits on the event on its own stream, copies each
distinct device buffer to pageable host memory through two small pinned
buffers (pinning a checkpoint's worth of memory would hold up the step
loop's CUDA calls), and then drops the device copies; every CUDA call it
makes holds
``compiler.aot.CAPTURE_LOCK`` (a CUDA graph captured meanwhile on another
thread must not see them). The bytes an async save writes are those of a
blocking save of the same step. Both stream the npz into the data file
:data:`IO_CHUNK` at a time: on the writer thread, a call that copies a
whole tensor would hold the GIL, and the step loop with it.

Not ported: sharded tensors (a ``sharded_layout`` raises, ROADMAP Queue 1
item 11) and the HBM ledger's ``snapshot`` class (telemetry).
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import atomic
from . import metrics as _m

# private: False makes the writer's copy to the host not wait for the
# snapshot's event (a planted fault: it reads copies still in flight)
_wait_for_snapshot = True

INDEX_VERSION = 2  # v2 adds checksum/data_bytes/sharding fields
BF16_DESCR = "<V2"  # the .npy header numpy's bfloat16 writes


def npz_key(key: str) -> str:
    return key.replace("/", "|")


def dtype_name(t: torch.Tensor) -> str:
    """The index's dtype name of a store tensor (``str`` of the JAX
    array's dtype: ``"bfloat16"``, ``"float32"``, ``"int32"``, ...)."""
    return str(t.dtype).replace("torch.", "")


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of a store tensor for the npz: bf16 as its raw 2-byte
    values (``V2``), everything else as its numpy dtype."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.dtype("V2"))
    return t.cpu().numpy()


def tensor_from_entry(value: np.ndarray, dtype_in_index: Optional[str]
                      ) -> torch.Tensor:
    """A CPU tensor of an npz entry: the raw 2-byte values of a
    ``"bfloat16"`` entry as bf16 bits (any 2-byte dtype: ``V2``, numpy's
    ``bfloat16``), else the values."""
    value = np.array(value, order="C")  # a 0-d entry stays 0-d
    if dtype_in_index == "bfloat16" or (
            value.dtype.kind == "V" and value.dtype.itemsize == 2):
        return torch.from_numpy(value.view(np.int16)).view(torch.bfloat16)
    if value.dtype.kind == "V":
        raise ValueError(f"raw {value.dtype} values without a dtype in the "
                         "checkpoint index")
    return torch.from_numpy(value)


# bytes a write or a checksum read takes at a time. A checkpoint is
# written from the writer thread beside the step loop: one Python call
# that copies a whole tensor (``tobytes``, a growing ``BytesIO``) holds
# the GIL, and the step loop with it, for as long as the copy takes.
IO_CHUNK = 64 << 20


def _write_npy(fid, arr: np.ndarray) -> None:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": BF16_DESCR, "fortran_order": False,
                  "shape": arr.shape})
        raw = memoryview(np.ascontiguousarray(arr).view(np.uint16)
                         .reshape(-1)).cast("B")
        for lo in range(0, raw.nbytes, IO_CHUNK):
            fid.write(raw[lo:lo + IO_CHUNK])
    else:
        # numpy writes to a non-file in 16 MiB pieces
        np.lib.format.write_array(fid, np.asanyarray(arr))


def _write_npz(f, arrays: Dict[str, np.ndarray]) -> None:
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(npz_key(key) + ".npy", "w", force_zip64=True) as e:
                _write_npy(e, arr)


def encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    """The .stfz payload as in-memory bytes, as it lands on disk:
    ``np.savez``'s container (stored zip, ZIP64 entries), each entry
    ``<npz key>.npy``; 2-byte raw values with the bf16 header."""
    buf = io.BytesIO()
    _write_npz(buf, arrays)
    return buf.getvalue()


def build_index_doc(tensor_index, host_state, backend="native",
                    payload: Optional[bytes] = None) -> Dict[str, Any]:
    doc = {"tensors": tensor_index, "version": INDEX_VERSION,
           "backend": backend, "host_state": host_state,
           "time": time.time()}
    if payload is not None:
        doc["checksum"] = atomic.checksum_bytes(payload)
        doc["data_bytes"] = len(payload)
    return doc


def _refuse_sharded(tensor_index) -> None:
    sharded = [k for k, meta in tensor_index.items()
               if meta.get("sharded_layout")]
    if sharded:
        raise NotImplementedError(
            f"per-shard checkpoint entries {sharded[:3]} are not ported "
            "(ROADMAP Queue 1 item 11)")


def write_native_checkpoint(prefix: str, arrays: Dict[str, np.ndarray],
                            tensor_index, host_state,
                            timings: Optional[dict] = None
                            ) -> Dict[str, Any]:
    """Serialize and commit one native checkpoint: the npz streamed into
    the data file's atomic write (:data:`IO_CHUNK` at a time), its
    checksum read back from the committed file, then the atomic index
    write. The ``checkpoint`` state file is not touched (the caller
    updates it last). ``timings``, a dict, gets the seconds of
    ``"serialize"`` (the npz written and the checksum read) and
    ``"commit"`` (flush, fsyncs, renames, the index)."""
    _refuse_sharded(tensor_index)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    data_path = prefix + ".stfz"
    t0 = time.perf_counter()
    written = []

    def write(f):
        _write_npz(f, arrays)
        written.append(time.perf_counter())

    atomic.atomic_write(data_path, write, label="data")
    t1 = time.perf_counter()
    doc = build_index_doc(tensor_index, host_state, "native")
    doc["checksum"] = atomic.checksum_file(data_path, chunk_size=IO_CHUNK)
    doc["data_bytes"] = os.path.getsize(data_path)
    t2 = time.perf_counter()
    atomic.atomic_write_bytes(prefix + ".index.json",
                              json.dumps(doc, indent=1).encode("utf-8"),
                              label="index")
    if timings is not None:
        timings["serialize"] = (written[0] - t0) + (t2 - t1)
        timings["commit"] = (t1 - written[0]) + (time.perf_counter() - t2)
    return doc


def read_index(prefix: str) -> Dict[str, Any]:
    with open(prefix + ".index.json") as f:
        return json.load(f)


def _dtype_matches(arr: np.ndarray, name: Optional[str]) -> bool:
    if name == "bfloat16":
        return arr.dtype.itemsize == 2 and arr.dtype.kind in "Vf"
    return str(arr.dtype) == name


def verify_checkpoint(prefix: str) -> List[str]:
    """Integrity-check one checkpoint; the problems found (empty when it
    verifies): missing files, a size or sha256 that differs from the
    index's, a tensor missing from the data file or of another shape or
    dtype. A bf16 tensor's raw 2-byte entry matches ``"bfloat16"``. Each
    failure counts on ``/stf/checkpoint/integrity_failures`` by kind, as
    in the JAX package."""
    problems: List[str] = []

    def _fail(kind: str, msg: str):
        _m.integrity_failures.get_cell(kind).increase_by(1)
        problems.append(msg)

    index_path = prefix + ".index.json"
    if not os.path.exists(index_path):
        _fail("missing_file", f"{index_path}: missing index file")
        return problems
    try:
        doc = read_index(prefix)
        tensors = doc["tensors"]
    except (json.JSONDecodeError, KeyError, OSError) as e:
        _fail("bad_index", f"{index_path}: unreadable index ({e})")
        return problems
    data_path = prefix + ".stfz"
    if not os.path.exists(data_path):
        _fail("missing_file", f"{data_path}: missing tensor data file")
        return problems
    expected = doc.get("checksum")
    if expected is not None:
        nbytes = os.path.getsize(data_path)
        if doc.get("data_bytes") is not None and nbytes != doc["data_bytes"]:
            _fail("checksum_mismatch", f"{data_path}: size {nbytes} != "
                  f"recorded {doc['data_bytes']}")
            return problems
        actual = atomic.checksum_file(data_path)
        if actual != expected:
            _fail("checksum_mismatch", f"{data_path}: checksum {actual} != "
                  f"recorded {expected}")
            return problems
    _refuse_sharded(tensors)
    try:
        with np.load(data_path, allow_pickle=False) as data:
            files = set(data.files)
            for key, meta in tensors.items():
                nk = npz_key(key)
                if nk not in files:
                    _fail("tensor_mismatch", f"{prefix}: tensor {key!r} in "
                          "index but not in data file")
                    continue
                arr = data[nk]
                if list(arr.shape) != list(meta.get("shape", [])) or \
                        not _dtype_matches(arr, meta.get("dtype")):
                    _fail("tensor_mismatch",
                          f"{prefix}: tensor {key!r} is {arr.dtype}"
                          f"{list(arr.shape)}, index says "
                          f"{meta.get('dtype')}{meta.get('shape')}")
    except Exception as e:  # noqa: BLE001 - any load failure is corrupt
        _fail("tensor_mismatch", f"{data_path}: unreadable npz ({e})")
    return problems


class DeviceCopies(dict):
    """``{store name: copy}`` of a barrier snapshot: views of ``bases``,
    the distinct buffers copied (a flat group once, any other entry as a
    clone); ``ready`` is the event recorded after the copies (None on the
    CPU)."""

    def __init__(self):
        super().__init__()
        self.bases: List[torch.Tensor] = []
        self.ready = None


def device_copies(tensors: Dict[str, torch.Tensor],
                  flat_buffers=()) -> DeviceCopies:
    """Copies of ``tensors`` on their device, on the current stream (the
    one a step ran on): an entry that views one of ``flat_buffers`` (the
    optimizer's flat groups) becomes the same view of that buffer's copy,
    made once; any other entry is cloned. The event ``ready`` is recorded
    after the copies."""
    flats = {f.untyped_storage().data_ptr(): f for f in flat_buffers}
    out = DeviceCopies()
    copied: Dict[int, torch.Tensor] = {}
    with torch.no_grad():
        for name, t in tensors.items():
            f = flats.get(t.untyped_storage().data_ptr())
            if f is None or f.dtype != t.dtype:
                c = t.detach().clone(
                    memory_format=torch.contiguous_format)
                out.bases.append(c)
                out[name] = c
                continue
            c = copied.get(id(f))
            if c is None:
                c = copied[id(f)] = torch.empty_like(f)
                c.copy_(f)
                out.bases.append(c)
            out[name] = c.as_strided(
                t.shape, t.stride(), t.storage_offset() - f.storage_offset())
    if out.bases and out.bases[0].device.type == "cuda":
        out.ready = torch.cuda.Event()
        out.ready.record()
    return out


def _cuda_lock():
    from ..compiler import aot

    return aot.CAPTURE_LOCK


# bytes a pinned bounce buffer holds; two of them, allocated once a process
# (the host caching allocator keeps them). Pinning holds up the step
# loop's CUDA calls: a whole checkpoint's worth (2.4 GB) took 0.8-1 s
# beside an H100, two 256 MiB buffers 0.23 s, two of 64 MiB 0.06 s; a
# pageable copy instead holds them up ~0.3 s at every save.
D2H_CHUNK = 64 << 20


def _wait(event) -> None:
    """Wait for ``event`` on the host, holding the capture lock only
    around each query (a capture on another thread waits for no more than
    one query)."""
    while True:
        with _cuda_lock():
            if event.query():
                return
        time.sleep(1e-4)


def _copy_to_host(copies: DeviceCopies) -> Dict[int, torch.Tensor]:
    """``{id(base): host copy}`` of ``copies.bases`` (contiguous, on one
    card): after ``copies.ready`` (unless ``_wait_for_snapshot`` is off, a
    planted fault), in chunks of :data:`D2H_CHUNK` into two pinned buffers
    in turn, each drained into pageable memory once its copy's event has
    completed. Every CUDA call holds the capture lock."""
    dev = copies.bases[0].device
    with _cuda_lock():
        stream = torch.cuda.Stream(dev)
        if _wait_for_snapshot:
            stream.wait_event(copies.ready)
        bounce = [torch.empty(D2H_CHUNK, dtype=torch.uint8, pin_memory=True)
                  for _ in range(2)]
    pending = [None, None]   # (event, host bytes to fill) of each buffer
    turn = 0

    def drain(i):
        event, dst = pending[i]
        _wait(event)
        dst.copy_(bounce[i][:dst.numel()])
        pending[i] = None

    host_of = {}
    for b in copies.bases:
        h = torch.empty(b.shape, dtype=b.dtype)
        host_of[id(b)] = h
        if b.numel() == 0:
            continue
        src = b.view(-1).view(torch.uint8)
        dst = h.reshape(-1).view(torch.uint8)
        for lo in range(0, src.numel(), D2H_CHUNK):
            hi = min(lo + D2H_CHUNK, src.numel())
            if pending[turn] is not None:
                drain(turn)
            with _cuda_lock(), torch.cuda.stream(stream):
                bounce[turn][:hi - lo].copy_(src[lo:hi], non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            pending[turn] = (event, dst[lo:hi])
            turn ^= 1
        with _cuda_lock():
            b.record_stream(stream)
    for i in (turn, turn ^ 1):
        if pending[i] is not None:
            drain(i)
    return host_of


class TrainingStateSnapshot:
    """A point-in-time capture of the training state: ``copies`` (the
    :class:`DeviceCopies` of every saved store entry), ``tensor_index``
    ``{checkpoint key: {dtype, shape, store_name, sharding}}`` and
    ``host_state``. Until :meth:`release_device_state` the device holds
    one more copy of the saved state."""

    __slots__ = ("copies", "keys", "tensor_index", "host_state", "step",
                 "captured_at", "graph", "timings")

    def __init__(self, copies: DeviceCopies, keys: Dict[str, str],
                 tensor_index, host_state, step=None, graph=None):
        self.copies = copies
        self.keys = keys          # checkpoint key -> store name
        self.tensor_index = tensor_index
        self.host_state = host_state
        self.step = step
        self.captured_at = time.time()
        self.graph = graph
        self.timings: Dict[str, float] = {}

    def materialize(self) -> Dict[str, np.ndarray]:
        """``{checkpoint key: host array}`` (bf16 as its 2-byte values),
        in the index's order (the writer thread's side): on the card, a
        wait on the snapshot's event, then each distinct buffer copied to
        pageable host memory through two small pinned buffers on a stream
        of its own (:func:`_copy_to_host`); ``timings["d2h"]`` gets the
        seconds."""
        t0 = time.perf_counter()
        copies = self.copies
        if copies.ready is not None:
            host_of = _copy_to_host(copies)
        else:
            host_of = {id(b): b for b in copies.bases}
        base_of = {}
        for b in copies.bases:
            base_of[b.untyped_storage().data_ptr()] = b
        arrays = {}
        for key, store_name in self.keys.items():
            v = copies[store_name]
            b = base_of[v.untyped_storage().data_ptr()]
            h = host_of[id(b)]
            arrays[key] = host_array(h.as_strided(
                v.shape, v.stride(), v.storage_offset() - b.storage_offset()))
        self.timings["d2h"] = time.perf_counter() - t0
        return arrays

    def release_device_state(self) -> None:
        """Drop the device copies (idempotent)."""
        copies, self.copies = self.copies, DeviceCopies()
        with _cuda_lock():
            copies.clear()
            copies.bases.clear()
            copies.ready = None

    def nbytes(self) -> int:
        return int(sum(b.numel() * b.element_size()
                       for b in self.copies.bases))


def capture_training_state(sess, vars_map) -> TrainingStateSnapshot:
    """The barrier snapshot of ``vars_map`` (``{checkpoint key:
    Variable}``, a Saver's ``_vars``): device copies and the host state
    under the session's lock (``Session.snapshot_device_state``), so it
    never interleaves with a step. ``FailedPreconditionError`` when a
    variable is uninitialized, as ``Saver.save``."""
    from ..framework import errors

    names = {key: (v.var_name if hasattr(v, "var_name") else key)
             for key, v in vars_map.items()}
    store = sess._variable_store
    missing = sorted(n for n in names.values() if n not in store.values)
    if missing:
        raise errors.FailedPreconditionError(
            None, None,
            f"Variable(s) {missing} uninitialized; cannot checkpoint.")
    copies, host_state = sess.snapshot_device_state(
        sorted(set(names.values())))
    index = {key: {"dtype": dtype_name(copies[n]),
                   "shape": list(copies[n].shape), "store_name": n,
                   "sharding": None}
             for key, n in names.items()}
    return TrainingStateSnapshot(copies, names, index, host_state,
                                 graph=sess.graph)
