"""gfile shim (ref: tensorflow/python/lib/io/file_io.py); the port's copy
of ``simple_tensorflow_tpu/lib/io/file_io.py``."""

from __future__ import annotations

import glob as _glob
import os
import shutil


def file_exists(filename):
    return os.path.exists(filename)


def delete_file(filename):
    os.remove(filename)


def read_file_to_string(filename, binary_mode=False):
    with open(filename, "rb" if binary_mode else "r") as f:
        return f.read()


def write_string_to_file(filename, file_content):
    mode = "wb" if isinstance(file_content, bytes) else "w"
    with open(filename, mode) as f:
        f.write(file_content)


def get_matching_files(filename):
    return sorted(_glob.glob(filename))


def create_dir(dirname):
    os.mkdir(dirname)


def recursive_create_dir(dirname):
    os.makedirs(dirname, exist_ok=True)


def copy(oldpath, newpath, overwrite=False):
    if os.path.exists(newpath) and not overwrite:
        raise OSError(f"{newpath} exists")
    shutil.copy(oldpath, newpath)


def rename(oldname, newname, overwrite=False):
    if os.path.exists(newname) and not overwrite:
        raise OSError(f"{newname} exists")
    os.replace(oldname, newname)


def is_directory(dirname):
    return os.path.isdir(dirname)


def list_directory(dirname):
    return os.listdir(dirname)


def walk(top, in_order=True):
    yield from os.walk(top)


def stat(filename):
    return os.stat(filename)


class GFile:
    """(ref: python/platform/gfile.py ``GFile``)."""

    def __init__(self, name, mode="r"):
        self._f = open(name, mode)

    def __getattr__(self, item):
        return getattr(self._f, item)

    def __enter__(self):
        return self._f

    def __exit__(self, *exc):
        self._f.close()
        return False


Open = GFile
Exists = file_exists
MakeDirs = recursive_create_dir
Glob = get_matching_files
Remove = delete_file
IsDirectory = is_directory
ListDirectory = list_directory
Rename = rename
Copy = copy
Walk = walk
Stat = stat
