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

Not ported: sharded tensors (a ``sharded_layout`` raises, ROADMAP Queue 1
item 11), the async plane's barrier snapshots (``TrainingStateSnapshot``,
Queue 1 item 10) and the monitoring counters.
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


def _write_npy(fid, arr: np.ndarray) -> None:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        np.lib.format.write_array_header_1_0(
            fid, {"descr": BF16_DESCR, "fortran_order": False,
                  "shape": arr.shape})
        fid.write(np.ascontiguousarray(arr).view(np.uint16).tobytes())
    else:
        np.lib.format.write_array(fid, np.asanyarray(arr))


def encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    """The .stfz payload as in-memory bytes (the content checksum covers
    exactly what lands on disk): ``np.savez``'s container (stored zip,
    ZIP64 entries), each entry ``<npz key>.npy``; 2-byte raw values with
    the bf16 header."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(npz_key(key) + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, arr)
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
    """Serialize and commit one native checkpoint: npz bytes, checksum,
    atomic data write, atomic index write. The ``checkpoint`` state file
    is not touched (the caller updates it last). ``timings``, a dict,
    gets the seconds of ``"serialize"`` (npz and checksum) and
    ``"commit"``."""
    _refuse_sharded(tensor_index)
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    t0 = time.perf_counter()
    payload = encode_npz(arrays)
    doc = build_index_doc(tensor_index, host_state, "native",
                          payload=payload)
    index_bytes = json.dumps(doc, indent=1).encode("utf-8")
    t1 = time.perf_counter()
    atomic.atomic_write_bytes(prefix + ".stfz", payload, label="data")
    atomic.atomic_write_bytes(prefix + ".index.json", index_bytes,
                              label="index")
    if timings is not None:
        timings["serialize"] = t1 - t0
        timings["commit"] = time.perf_counter() - t1
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
    dtype. A bf16 tensor's raw 2-byte entry matches ``"bfloat16"``."""
    problems: List[str] = []
    index_path = prefix + ".index.json"
    if not os.path.exists(index_path):
        return [f"{index_path}: missing index file"]
    try:
        doc = read_index(prefix)
        tensors = doc["tensors"]
    except (json.JSONDecodeError, KeyError, OSError) as e:
        return [f"{index_path}: unreadable index ({e})"]
    data_path = prefix + ".stfz"
    if not os.path.exists(data_path):
        return [f"{data_path}: missing tensor data file"]
    expected = doc.get("checksum")
    if expected is not None:
        nbytes = os.path.getsize(data_path)
        if doc.get("data_bytes") is not None and nbytes != doc["data_bytes"]:
            return [f"{data_path}: size {nbytes} != recorded "
                    f"{doc['data_bytes']}"]
        actual = atomic.checksum_file(data_path)
        if actual != expected:
            return [f"{data_path}: checksum {actual} != recorded "
                    f"{expected}"]
    try:
        _refuse_sharded(tensors)
        with np.load(data_path, allow_pickle=False) as data:
            files = set(data.files)
            for key, meta in tensors.items():
                nk = npz_key(key)
                if nk not in files:
                    problems.append(f"{prefix}: tensor {key!r} in index but "
                                    "not in data file")
                    continue
                arr = data[nk]
                if list(arr.shape) != list(meta.get("shape", [])) or \
                        not _dtype_matches(arr, meta.get("dtype")):
                    problems.append(
                        f"{prefix}: tensor {key!r} is {arr.dtype}"
                        f"{list(arr.shape)}, index says {meta.get('dtype')}"
                        f"{meta.get('shape')}")
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 - any load failure is corrupt
        problems.append(f"{data_path}: unreadable npz ({e})")
    return problems
