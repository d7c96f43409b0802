"""Dtype table: numpy dtype <-> "DT_*" name <-> DataType enum, without
ml_dtypes or protobuf.

The enum numbers are tensorflow.DataType's (tf_tensor.proto). numpy has no
bfloat16 without ml_dtypes, so DT_BFLOAT16 is known by name and number but
has no numpy dtype here: a wire tensor of that type is INVALID_ARGUMENT
until the port carries bf16 across the wire.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from min_tfs_client_tpu_torch.utils.status import ServingError


@dataclass(frozen=True)
class _Entry:
    enum: int
    tf_name: str
    np_dtype: Optional[np.dtype]  # canonical numpy dtype (None: DT_BFLOAT16)
    field: str                    # authoritative TensorProto typed field
    # numpy dtype the typed field's elements use on the wire (half_val
    # carries 16-bit floats as int32 bit patterns).
    wire_dtype: Optional[np.dtype]


def _e(enum, tf_name, np_dtype, field, wire_dtype=None):
    np_dtype = None if np_dtype is None else np.dtype(np_dtype)
    wire = np.dtype(wire_dtype) if wire_dtype else np_dtype
    return _Entry(enum, tf_name, np_dtype, field, wire)


_ENTRIES = [
    _e(1, "DT_FLOAT", np.float32, "float_val"),
    _e(2, "DT_DOUBLE", np.float64, "double_val"),
    _e(3, "DT_INT32", np.int32, "int_val"),
    _e(4, "DT_UINT8", np.uint8, "int_val", np.int32),
    _e(5, "DT_INT16", np.int16, "int_val", np.int32),
    _e(6, "DT_INT8", np.int8, "int_val", np.int32),
    _e(7, "DT_STRING", np.object_, "string_val"),
    _e(8, "DT_COMPLEX64", np.complex64, "scomplex_val", np.float32),
    _e(9, "DT_INT64", np.int64, "int64_val"),
    _e(10, "DT_BOOL", np.bool_, "bool_val"),
    _e(14, "DT_BFLOAT16", None, "half_val", np.int32),
    _e(17, "DT_UINT16", np.uint16, "int_val", np.int32),
    _e(18, "DT_COMPLEX128", np.complex128, "dcomplex_val", np.float64),
    _e(19, "DT_HALF", np.float16, "half_val", np.int32),
    _e(22, "DT_UINT32", np.uint32, "uint32_val"),
    _e(23, "DT_UINT64", np.uint64, "uint64_val"),
]

_BY_ENUM = {e.enum: e for e in _ENTRIES}
_BY_NAME = {e.tf_name: e for e in _ENTRIES}
# np.object_ maps to DT_STRING; np.str_ / bytes handled in _resolve().
_BY_NP = {e.np_dtype: e for e in reversed(_ENTRIES) if e.np_dtype is not None}

# Legacy TF1 "ref" dtype variants share wire semantics with the base dtype.
_REF_OFFSET = 100


class UnsupportedDtypeError(TypeError):
    pass


class DataType:
    """One dtype, constructible from any of its three spellings."""

    __slots__ = ("_entry",)

    def __init__(self, value):
        self._entry = _resolve(value)

    @property
    def numpy_dtype(self) -> np.dtype:
        if self._entry.np_dtype is None:
            raise ServingError.invalid_argument(
                f"{self.tf_dtype} tensors are not supported by the PyTorch "
                "port yet (numpy has no bfloat16 without ml_dtypes)")
        return self._entry.np_dtype

    @property
    def tf_dtype(self) -> str:
        return self._entry.tf_name

    @property
    def enum(self) -> int:
        return self._entry.enum

    @property
    def proto_field_name(self) -> str:
        return self._entry.field

    @property
    def wire_dtype(self) -> np.dtype:
        return self._entry.wire_dtype

    @property
    def is_string(self) -> bool:
        return self._entry.field == "string_val"

    def __eq__(self, other):
        return isinstance(other, DataType) and other.enum == self.enum

    def __hash__(self):
        return hash(self.enum)

    def __repr__(self):
        return f"DataType({self.tf_dtype})"


def _resolve(value) -> _Entry:
    if isinstance(value, DataType):
        return value._entry
    if isinstance(value, str):
        try:
            return _BY_NAME[value]
        except KeyError:
            raise UnsupportedDtypeError(f"unknown TF dtype name {value!r}")
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        enum = int(value)
        if enum > _REF_OFFSET:
            enum -= _REF_OFFSET
        try:
            return _BY_ENUM[enum]
        except KeyError:
            raise UnsupportedDtypeError(f"unsupported DataType enum {value}")
    try:
        np_dtype = np.dtype(value)
    except TypeError:
        raise UnsupportedDtypeError(f"cannot interpret {value!r} as a dtype")
    if np_dtype.kind in ("U", "S", "O"):
        return _BY_NAME["DT_STRING"]
    try:
        return _BY_NP[np_dtype]
    except KeyError:
        raise UnsupportedDtypeError(f"unsupported numpy dtype {np_dtype}")


def all_supported() -> list[str]:
    return [e.tf_name for e in _ENTRIES]
