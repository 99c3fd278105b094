"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``simple_tensorflow_tpu_torch/csrc/*.cu`` for
``sm_90a`` (all sources at once, one process each), links the objects into
one shared library with a plain C interface, and ``ctypes`` loads it. The
build lands in ``simple_tensorflow_tpu_torch/_build/`` (git-ignored) under a
name keyed by the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library. It runs on first use, never at
import: the CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_uint
# the dropout arguments of the flash kernels: rate > 0 as 0/1, seed,
# keep threshold, f32(1 / keep_prob)
_DROP = [_I, _U, _U, _F]
# the same after the causal flag in the seed-pointer entries: the seed's
# device pointer, keep threshold, f32(1 / keep_prob)
_DROP_PTR = [_P, _U, _F]
# argtypes of every C entry point: pointers and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
SIGNATURES = {
    "stf_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I,
                           _P],
    "stf_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    "stf_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _F, _I, _I, _I, _P],
    "stf_quant_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "stf_flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _F, _I, *_DROP, _I, _P],
    "stf_flash_attention_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _F, _I, *_DROP, _I, _P],
    "stf_flash_attention_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, *_DROP, _I, _P],
    "stf_flash_attention_fwd_seed_ptr": [_P] * 6 + [_I] * 5 + [
        _F, _I, *_DROP_PTR, _I, _P],
    "stf_flash_attention_dkdv_seed_ptr": [_P] * 9 + [_I] * 5 + [
        _F, _I, *_DROP_PTR, _I, _P],
    "stf_flash_attention_dq_seed_ptr": [_P] * 8 + [_I] * 5 + [
        _F, _I, *_DROP_PTR, _I, _P],
    "stf_softmax_xent_fwd": [_P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P],
    "stf_softmax_xent_bwd": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _P],
    "stf_adam_update": [_P, _P, _P, _P, _P, _L, _F, _F, _F, _I, _P],
    "stf_momentum_update": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    "stf_dropout_residual": [_P, _P, _P, _P, _I, _I, _U, _U, _F, _I, _I,
                             _P],
    "stf_dropout_residual_seed_ptr": [_P, _P, _P, _P, _I, _I, _P, _U, _F,
                                      _I, _I, _P],
    "stf_dropout": [_P, _P, _P, _L, _U, _U, _U, _F, _I, _I, _P],
    "stf_dropout_key": [_P, _P, _P, _L, _P, _U, _F, _I, _I, _P],
    "stf_dropout_bwd": [_P, _P, _P, _L, _F, _I, _I, _P],
    "stf_cond_set": [_P, ctypes.c_ulonglong, _P, _I],
    "stf_cond_node_begin": [_P, _I, _P, _I, _P, _P],
    "stf_capture_to_graph_begin": [_P, _P],
    "stf_capture_to_graph_end": [_P],
    "stf_graph_node_count": [_P, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source on first use")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> str:
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{lib_path.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib_path.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / f"libstf_kernels_{_key()}.so"
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib_path.exists():
                build_log = _build(lib_path)
                (BUILD_DIR / "build.log").write_text(build_log)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def stream_handle(device) -> int:
    """The current PyTorch stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
