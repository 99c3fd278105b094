"""DType system of the port: the JAX package's ``framework/dtypes.py``
(``DType``, ``as_dtype``, the registry of names) with the mapping to torch
dtypes beside the numpy one.

The JAX package runs with ``jax_enable_x64`` off, so a 64-bit request
computes in its 32-bit sibling (``narrowed_if_no_x64``, :255). The port
fixes that rule on: int64/uint64/float64 tensors compute and fetch as
int32/uint32/float32, and :attr:`DType.torch_dtype` is already narrowed.
``string`` (numpy ``object``) types the host-only tensors: the serialized
protos summary ops produce, which never live on the device (its
``torch_dtype`` raises). Left out: the quantized and fp8 names and the
once-per-process narrowing warning.
"""

from __future__ import annotations

import builtins
import dataclasses

import numpy as np
import torch

try:  # bfloat16 numpy values when ml_dtypes is installed
    import ml_dtypes as _mld

    _BFLOAT16_NP = np.dtype(_mld.bfloat16)
except ImportError:  # pragma: no cover - numpy has no bfloat16
    _BFLOAT16_NP = np.dtype(np.float32)

_64BIT_NARROWING = {"int64": "int32", "uint64": "uint32",
                    "float64": "float32"}


@dataclasses.dataclass(frozen=True)
class DType:
    """A tensor element type: a hashable name over a numpy dtype, with the
    reference's classification properties (``ref: python/framework/
    dtypes.py:31``)."""

    name: str
    np_dtype: np.dtype
    _is_ref: bool = False

    @property
    def is_floating(self) -> bool:
        return self.np_dtype.kind == "f" or self.name.startswith("bfloat")

    @property
    def is_integer(self) -> bool:
        return self.np_dtype.kind in ("i", "u") and \
            not self.name.startswith("bfloat")

    @property
    def is_unsigned(self) -> bool:
        return self.np_dtype.kind == "u"

    @property
    def is_complex(self) -> bool:
        return self.np_dtype.kind == "c"

    @property
    def is_bool(self) -> bool:
        return self.np_dtype.kind == "b"

    @property
    def as_numpy_dtype(self):
        return self.np_dtype.type

    @property
    def base_dtype(self) -> "DType":
        if self._is_ref:
            return _BY_NAME[self.name[: -len("_ref")]]
        return self

    @property
    def _ref(self) -> "DType":
        if self._is_ref:
            return self
        return DType(self.name + "_ref", self.np_dtype, True)

    @property
    def is_ref_dtype(self) -> bool:
        return self._is_ref

    @property
    def torch_dtype(self) -> torch.dtype:
        """The torch dtype this type computes in (64-bit narrowed)."""
        name = narrowed_if_no_x64(self).name
        if name == "string":
            raise TypeError("string tensors live on the host only")
        return _TORCH[name]

    @property
    def size(self) -> int:
        return self.np_dtype.itemsize

    def is_compatible_with(self, other) -> bool:
        return self.base_dtype == as_dtype(other).base_dtype

    def __str__(self):
        return f"<dtype: '{self.name}'>"

    def __repr__(self):
        return f"stf.{self.name}"

    def __eq__(self, other):
        if other is None:
            return False
        try:
            other = as_dtype(other)
        except TypeError:
            return NotImplemented
        return self.name == other.name

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self.name)


float16 = DType("float16", np.dtype(np.float16))
half = float16
bfloat16 = DType("bfloat16", _BFLOAT16_NP)
float32 = DType("float32", np.dtype(np.float32))
float64 = DType("float64", np.dtype(np.float64))
double = float64
int8 = DType("int8", np.dtype(np.int8))
int16 = DType("int16", np.dtype(np.int16))
int32 = DType("int32", np.dtype(np.int32))
int64 = DType("int64", np.dtype(np.int64))
uint8 = DType("uint8", np.dtype(np.uint8))
uint32 = DType("uint32", np.dtype(np.uint32))
uint64 = DType("uint64", np.dtype(np.uint64))
bool_ = DType("bool", np.dtype(np.bool_))
string = DType("string", np.dtype(object))

_ALL = [float16, bfloat16, float32, float64, int8, int16, int32, int64,
        uint8, uint32, uint64, bool_, string]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME.update({d.name + "_ref": d._ref for d in _ALL})
_BY_NAME["half"] = float16
_BY_NAME["double"] = float64
_NP_TO_DTYPE = {}
for _d in _ALL[2:] + _ALL[:2]:  # bfloat16 last: float32 stands in for it
    _NP_TO_DTYPE.setdefault(_d.np_dtype, _d)  # when ml_dtypes is missing
# Python scalars: int -> int32, float -> float32 (as the JAX package)
_PY_DEFAULTS = {builtins.int: int32, builtins.float: float32,
                builtins.bool: bool_}
_TORCH = {"float16": torch.float16, "bfloat16": torch.bfloat16,
          "float32": torch.float32, "int8": torch.int8,
          "int16": torch.int16, "int32": torch.int32, "uint8": torch.uint8,
          "uint32": torch.uint32, "bool": torch.bool}
_FROM_TORCH = {t: _BY_NAME[n] for n, t in _TORCH.items()}
_FROM_TORCH.update({torch.int64: int64, torch.float64: float64})


def as_dtype(value) -> DType:
    """``value`` (DType, name, numpy dtype, Python type or torch dtype) as
    a DType (``ref: python/framework/dtypes.py:580``)."""
    if isinstance(value, DType):
        return value
    if value is None:
        raise TypeError("Cannot convert None to DType")
    if isinstance(value, str):
        if value in _BY_NAME:
            return _BY_NAME[value]
        raise TypeError(f"Cannot convert {value!r} to a DType")
    if isinstance(value, torch.dtype):
        if value in _FROM_TORCH:
            return _FROM_TORCH[value]
        raise TypeError(f"Cannot convert {value!r} to a DType")
    if value in _PY_DEFAULTS:
        return _PY_DEFAULTS[value]
    try:
        np_dt = np.dtype(value)
    except TypeError:
        raise TypeError(f"Cannot convert {value!r} to a DType") from None
    if np_dt in _NP_TO_DTYPE:
        return _NP_TO_DTYPE[np_dt]
    raise TypeError(f"Cannot convert {value!r} to a DType")


def narrowed_if_no_x64(dtype) -> DType:
    """The dtype a request computes with: 64-bit types narrowed to their
    32-bit siblings (the JAX package's rule with x64 off)."""
    d = as_dtype(dtype).base_dtype
    return as_dtype(_64BIT_NARROWING.get(d.name, d.name))
