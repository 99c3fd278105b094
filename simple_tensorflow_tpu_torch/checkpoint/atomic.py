"""Atomic file commit protocol for checkpoints; the port's copy of
``simple_tensorflow_tpu/checkpoint/atomic.py``.

Every durable checkpoint artifact (tensor bundle, index, ``checkpoint``
state file) goes through ONE code path: write to a temp file in the
same directory, flush + fsync, ``os.replace`` over the destination,
then best-effort fsync of the directory entry. ``os.replace`` is atomic
on POSIX, so a reader (or a crash at ANY point) sees either the old
complete file or the new complete file — never a partial write (the
tensor_bundle writer in the reference makes the same guarantee via its
temp-then-rename commit, core/util/tensor_bundle/tensor_bundle.cc).

Fault injection: tests register a hook (``set_fault_hook``) that is
called at every named commit point (``"<label>:<point>"``) and may
raise to simulate a crash mid-commit.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Optional

# ordered commit points per file write; fault hooks receive
# "<label>:<point>" so a test can target e.g. "index:synced_tmp"
COMMIT_POINTS = ("open_tmp", "wrote_tmp", "synced_tmp", "replaced",
                 "dir_synced")

_fault_hook: Optional[Callable[[str], None]] = None


def set_fault_hook(hook: Optional[Callable[[str], None]]):
    """Install (or clear, with None) the crash-injection hook. Returns
    the previous hook so tests can restore it."""
    global _fault_hook
    prev, _fault_hook = _fault_hook, hook
    return prev


def _fault(point: str) -> None:
    if _fault_hook is not None:
        _fault_hook(point)


def checksum_bytes(data: bytes) -> str:
    """Content checksum in the ``sha256:<hex>`` form recorded in
    checkpoint indexes."""
    return "sha256:" + hashlib.sha256(data).hexdigest()


def checksum_file(path: str, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True,
                       label: Optional[str] = None) -> None:
    """Commit ``data`` to ``path`` atomically (see module docstring).

    ``fsync=False`` skips the durability syncs (still atomic against
    concurrent readers, not against power loss) — used only by paths
    that explicitly opt out, never by checkpoint commits.
    """
    label = label if label is not None else os.path.basename(path)
    d = os.path.dirname(path) or "."
    # dotfile temp name: directory listings / GC / ckpt_inspect ignore it
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        _fault(f"{label}:open_tmp")
        try:
            with os.fdopen(fd, "wb", closefd=False) as f:
                f.write(data)
                _fault(f"{label}:wrote_tmp")
                f.flush()
                if fsync:
                    os.fsync(fd)
        finally:
            os.close(fd)
        _fault(f"{label}:synced_tmp")
        os.replace(tmp, path)
        _fault(f"{label}:replaced")
        if fsync:
            # fsync the directory so the rename itself is durable;
            # best-effort — not every filesystem supports dir fds
            try:
                dfd = os.open(d, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass
        _fault(f"{label}:dir_synced")
    except BaseException:
        # an aborted commit must not litter half-written temp files
        # (a crash-kill still can; they are dotfiles readers ignore)
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj, fsync: bool = True,
                      label: Optional[str] = None) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode("utf-8"),
                       fsync=fsync, label=label)
