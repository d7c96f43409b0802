"""TensorProto <-> numpy marshalling (the JAX package's tensor/codec.py,
without its tracing spans).

Reads and writes both payload forms: the typed ``*_val`` fields and the
packed little-endian ``tensor_content``. Numeric arrays move as single
buffers, never element by element. protobuf is imported on first use, so
the port loads without it.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from min_tfs_client_tpu_torch.tensor.dtypes import DataType


def coerce_to_bytes(value) -> bytes:
    """utf-8 coercion for str; bytes pass through."""
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode("utf-8")
    raise TypeError(f"cannot coerce {type(value).__name__} to bytes")


def extract_shape(proto) -> tuple[int, ...] | None:
    if proto.tensor_shape.unknown_rank:
        return None
    return tuple(d.size for d in proto.tensor_shape.dim)


def _fill_shape(proto, shape: Iterable[int]) -> None:
    for s in shape:
        proto.tensor_shape.dim.add(size=int(s))


def ndarray_to_tensor_proto(
    arr: np.ndarray,
    *,
    use_tensor_content: bool = True,
    dtype: DataType | None = None,
):
    """Serialize an ndarray (or nested lists / scalars) to a TensorProto:
    the packed buffer by default, else the dtype's typed field. Strings
    always use ``string_val``."""
    from min_tfs_client_tpu_torch.protos import tf_tensor_pb2

    if not isinstance(arr, np.ndarray):
        arr = np.asarray(arr)
    dt = dtype or DataType(arr.dtype)
    proto = tf_tensor_pb2.TensorProto(dtype=dt.enum)
    _fill_shape(proto, arr.shape)

    if dt.is_string:
        flat = arr.reshape(-1)
        proto.string_val.extend(coerce_to_bytes(v) for v in flat.tolist())
        return proto

    arr = np.ascontiguousarray(arr.astype(dt.numpy_dtype, copy=False))
    if use_tensor_content:
        arr = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        proto.tensor_content = arr.tobytes()
        return proto

    field = getattr(proto, dt.proto_field_name)
    flat = arr.reshape(-1)
    if dt.proto_field_name == "half_val":
        flat = flat.view(np.uint16).astype(np.int32)  # bits widened to int32
    elif dt.proto_field_name in ("scomplex_val", "dcomplex_val"):
        flat = flat.view(dt.wire_dtype)  # interleaved re/im pairs
    elif flat.dtype != dt.wire_dtype:
        flat = flat.astype(dt.wire_dtype)
    field.extend(flat.tolist())
    return proto


def tensor_proto_to_ndarray(proto, *, writable: bool = True) -> np.ndarray:
    """Decode a TensorProto from either payload representation.
    ``writable=False`` keeps the tensor_content path zero-copy (a read-only
    view over the proto's bytes)."""
    dt = DataType(proto.dtype)
    shape = extract_shape(proto)
    if shape is None:
        raise ValueError("cannot decode a tensor of unknown rank")
    if any(d < 0 for d in shape):
        raise ValueError(f"cannot decode a tensor with unknown dims {shape}")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1

    if proto.tensor_content:
        if dt.is_string:
            raise ValueError("DT_STRING tensors cannot use tensor_content")
        wire = np.dtype(dt.numpy_dtype).newbyteorder("<")
        expected = n * wire.itemsize
        if len(proto.tensor_content) != expected:
            raise ValueError(
                f"tensor_content holds {len(proto.tensor_content)} bytes, "
                f"shape {shape} of {dt.tf_dtype} requires {expected}")
        arr = np.frombuffer(proto.tensor_content, dtype=wire, count=n)
        arr = arr.astype(dt.numpy_dtype, copy=False).reshape(shape)
        return arr.copy() if writable and not arr.flags.writeable else arr

    if dt.is_string:
        vals = list(proto.string_val)
        if len(vals) < n:  # TF splat/zero-fill semantics
            vals = vals + [vals[-1] if vals else b""] * (n - len(vals))
        elif len(vals) > n:
            raise ValueError(f"string_val holds {len(vals)} values, need {n}")
        out = np.empty(n, dtype=object)
        out[:] = vals
        return out.reshape(shape)

    np_dtype = dt.numpy_dtype  # raises for DT_BFLOAT16
    raw = np.asarray(getattr(proto, dt.proto_field_name), dtype=dt.wire_dtype)
    if dt.proto_field_name in ("scomplex_val", "dcomplex_val"):
        arr = _splat_np(np.ascontiguousarray(raw).view(np_dtype), n)
    elif dt.proto_field_name == "half_val":
        arr = _splat_np(raw, n).astype(np.uint16).view(np_dtype)
    else:
        arr = _splat_np(raw, n).astype(np_dtype, copy=False)
    return arr.reshape(shape)


def _splat_np(arr: np.ndarray, n: int) -> np.ndarray:
    """TF typed-field semantics (Tensor::FromProto): short arrays repeat
    the last element; empty arrays zero-fill; overlong arrays are an
    error."""
    if arr.size == n:
        return arr
    if arr.size > n:
        raise ValueError(f"typed field holds {arr.size} values, need {n}")
    fill = arr[-1] if arr.size else 0
    pad = np.full(n - arr.size, fill, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def tensor_protos_to_dict(protos: Mapping[str, object],
                          **kw) -> dict[str, np.ndarray]:
    """Decode a whole input dict. `writable=False` keeps the zero-copy
    path."""
    return {k: tensor_proto_to_ndarray(v, **kw) for k, v in protos.items()}
