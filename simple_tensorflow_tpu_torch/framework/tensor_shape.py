"""TensorShape: possibly-partial static shapes.

The port's copy of ``simple_tensorflow_tpu/framework/tensor_shape.py``
(ref: tensorflow/python/framework/tensor_shape.py). Semantics match the
reference: a shape is unknown rank, or a list of dimensions each of which may
be None. Partial shapes exist at graph-construction time; Session.run
executes with the concrete shapes of the actual feeds.
"""

from __future__ import annotations

from typing import List, Optional


class Dimension:
    """One dimension of a TensorShape; value may be None (unknown)."""

    __slots__ = ("_value",)

    def __init__(self, value):
        if isinstance(value, Dimension):
            self._value = value._value
        elif value is None:
            self._value = None
        else:
            self._value = int(value)
            if self._value < 0:
                raise ValueError(f"Dimension {self._value} must be >= 0")

    @property
    def value(self) -> Optional[int]:
        return self._value

    def is_compatible_with(self, other) -> bool:
        other = Dimension(other)
        return self._value is None or other._value is None or self._value == other._value

    def assert_is_compatible_with(self, other):
        if not self.is_compatible_with(other):
            raise ValueError(f"Dimensions {self} and {other} are not compatible")

    def merge_with(self, other) -> "Dimension":
        other = Dimension(other)
        self.assert_is_compatible_with(other)
        return Dimension(self._value if self._value is not None else other._value)

    def __eq__(self, other):
        try:
            other = Dimension(other)
        except (TypeError, ValueError):
            return NotImplemented
        if self._value is None or other._value is None:
            return None  # TF semantics: unknown == x is None
        return self._value == other._value

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else (None if eq is None else not eq)

    def __hash__(self):
        return hash(self._value)

    def __int__(self):
        if self._value is None:
            raise ValueError("Cannot convert unknown Dimension to int")
        return self._value

    def __index__(self):
        return self.__int__()

    def __repr__(self):
        return f"Dimension({self._value})"

    def __str__(self):
        return "?" if self._value is None else str(self._value)

    def _binop(self, other, fn):
        try:
            other = Dimension(other)
        except (TypeError, ValueError):
            return NotImplemented
        if self._value is None or other._value is None:
            return Dimension(None)
        return Dimension(fn(self._value, other._value))

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __floordiv__(self, other):
        return self._binop(other, lambda a, b: a // b)

    def __mod__(self, other):
        return self._binop(other, lambda a, b: a % b)


class TensorShape:
    """Static shape of a symbolic Tensor. May have unknown rank or dims."""

    __slots__ = ("_dims",)

    def __init__(self, dims=None):
        if dims is None:
            self._dims: Optional[List[Dimension]] = None
        elif isinstance(dims, TensorShape):
            self._dims = None if dims._dims is None else list(dims._dims)
        elif isinstance(dims, (int, Dimension)):
            self._dims = [Dimension(dims)]
        else:
            self._dims = [Dimension(d) for d in dims]

    # -- introspection -------------------------------------------------------
    @property
    def rank(self) -> Optional[int]:
        return None if self._dims is None else len(self._dims)

    @property
    def ndims(self) -> Optional[int]:
        return self.rank

    @property
    def dims(self) -> Optional[List[Dimension]]:
        return self._dims

    def num_elements(self) -> Optional[int]:
        if not self.is_fully_defined():
            return None
        n = 1
        for d in self._dims:
            n *= d.value
        return n

    def is_fully_defined(self) -> bool:
        return self._dims is not None and all(d.value is not None for d in self._dims)

    def assert_is_fully_defined(self):
        if not self.is_fully_defined():
            raise ValueError(f"Shape {self} is not fully defined")

    def is_compatible_with(self, other) -> bool:
        other = as_shape(other)
        if self._dims is None or other._dims is None:
            return True
        if len(self._dims) != len(other._dims):
            return False
        return all(a.is_compatible_with(b) for a, b in zip(self._dims, other._dims))

    def assert_is_compatible_with(self, other):
        if not self.is_compatible_with(other):
            raise ValueError(f"Shapes {self} and {other} are incompatible")

    def assert_has_rank(self, rank):
        if self.rank is not None and self.rank != rank:
            raise ValueError(f"Shape {self} must have rank {rank}")

    def merge_with(self, other) -> "TensorShape":
        other = as_shape(other)
        if self._dims is None:
            return TensorShape(other)
        if other._dims is None:
            return TensorShape(self)
        self.assert_is_compatible_with(other)
        return TensorShape([a.merge_with(b) for a, b in zip(self._dims, other._dims)])

    def with_rank(self, rank) -> "TensorShape":
        if self._dims is None:
            return unknown_shape(rank)
        self.assert_has_rank(rank)
        return self

    def with_rank_at_least(self, rank) -> "TensorShape":
        if self.rank is not None and self.rank < rank:
            raise ValueError(f"Shape {self} must have rank at least {rank}")
        return self

    def concatenate(self, other) -> "TensorShape":
        other = as_shape(other)
        if self._dims is None or other._dims is None:
            return TensorShape(None)
        return TensorShape(self._dims + other._dims)

    # -- conversion ----------------------------------------------------------
    def as_list(self) -> List[Optional[int]]:
        if self._dims is None:
            raise ValueError("as_list() is not defined on an unknown TensorShape")
        return [d.value for d in self._dims]

    def as_tuple(self):
        return tuple(self.as_list())

    # -- dunder --------------------------------------------------------------
    def __len__(self):
        if self._dims is None:
            raise ValueError("Cannot take the length of shape with unknown rank")
        return len(self._dims)

    def __iter__(self):
        if self._dims is None:
            raise ValueError("Cannot iterate over shape with unknown rank")
        return iter(self._dims)

    def __getitem__(self, key):
        if self._dims is None:
            if isinstance(key, slice):
                return TensorShape(None)
            return Dimension(None)
        if isinstance(key, slice):
            return TensorShape(self._dims[key])
        return self._dims[key]

    def __bool__(self):
        return self._dims is not None

    def __eq__(self, other):
        try:
            other = as_shape(other)
        except TypeError:
            return NotImplemented
        if self._dims is None or other._dims is None:
            return self._dims is None and other._dims is None
        return [d.value for d in self._dims] == [d.value for d in other._dims]

    def __hash__(self):
        if self._dims is None:
            return hash(None)
        return hash(tuple(d.value for d in self._dims))

    def __add__(self, other):
        return self.concatenate(other)

    def __radd__(self, other):
        return as_shape(other).concatenate(self)

    def __repr__(self):
        if self._dims is None:
            return "TensorShape(None)"
        return f"TensorShape({[d.value for d in self._dims]})"

    def __str__(self):
        if self._dims is None:
            return "<unknown>"
        return "(" + ", ".join(str(d) for d in self._dims) + ")"


def as_shape(shape) -> TensorShape:
    if isinstance(shape, TensorShape):
        return shape
    return TensorShape(shape)


def unknown_shape(rank=None) -> TensorShape:
    if rank is None:
        return TensorShape(None)
    return TensorShape([None] * rank)


def scalar() -> TensorShape:
    return TensorShape([])


def vector(length) -> TensorShape:
    return TensorShape([length])


def matrix(rows, cols) -> TensorShape:
    return TensorShape([rows, cols])
