"""Servable: a loaded model version exposing named signatures.

Counterpart of `min_tfs_client_tpu/servables/servable.py` for PyTorch:
signature lookup with the "serving_default" default, alias-keyed inputs
validated against their specs, output_filter validation, batch buckets
padded by repeating row 0, host->device placement onto the signature's
device, and a device->host fetch of only the requested outputs. Execution
is eager PyTorch under `torch.inference_mode()`.

Later slices add sequence bucketing, transfer casts, the mesh, and the
dispatch/ExecutionHandle split the in-flight window uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from min_tfs_client_tpu_torch.tensor.dtypes import DataType
from min_tfs_client_tpu_torch.utils.device import resolve_device
from min_tfs_client_tpu_torch.utils.status import ServingError

DEFAULT_SERVING_SIGNATURE_DEF_KEY = "serving_default"

PREDICT_METHOD_NAME = "tensorflow/serving/predict"
CLASSIFY_METHOD_NAME = "tensorflow/serving/classify"
REGRESS_METHOD_NAME = "tensorflow/serving/regress"

CLASSIFY_OUTPUT_SCORES = "scores"
REGRESS_OUTPUTS = "outputs"

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclass(frozen=True)
class TensorSpec:
    """Dtype + shape template; None dims are polymorphic (batch /
    sequence)."""

    dtype: object
    shape: tuple[Optional[int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "dtype", DataType(self.dtype))

    def validate(self, arr: np.ndarray, alias: str) -> None:
        if len(arr.shape) != len(self.shape):
            raise ServingError.invalid_argument(
                f"input {alias!r}: expected rank {len(self.shape)}, "
                f"got shape {arr.shape}")
        for i, (want, got) in enumerate(zip(self.shape, arr.shape)):
            if want is not None and want != got:
                raise ServingError.invalid_argument(
                    f"input {alias!r}: dim {i} expected {want}, got {got}")


@dataclass
class Signature:
    """One named entry point of a servable: `fn(params, inputs)` over a
    dict of tensors on `device`, returning a dict of tensors. The leading
    dim of every input is the shared batch dim."""

    fn: Callable[..., dict]
    inputs: dict[str, TensorSpec]
    outputs: dict[str, TensorSpec]
    params: Optional[object] = dc_field(default=None, repr=False,
                                        compare=False)
    device: object = None  # None: the CUDA card (raises without one)
    method_name: str = PREDICT_METHOD_NAME
    class_labels: Optional[Sequence[bytes]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def validate(
        self,
        inputs: Mapping[str, np.ndarray],
        output_filter: Sequence[str] = (),
    ) -> dict[str, np.ndarray]:
        """Per-request checks: aliases, output_filter, dtypes and shapes."""
        missing = set(self.inputs) - set(inputs)
        if missing:
            raise ServingError.invalid_argument(
                "Request inputs do not match required inputs for the "
                f"signature. Missing: {sorted(missing)}")
        extra = set(inputs) - set(self.inputs)
        if extra:
            raise ServingError.invalid_argument(
                f"inputs contain aliases not in the signature: {sorted(extra)}")
        for name in output_filter:
            if name not in self.outputs:
                raise ServingError.invalid_argument(
                    f"output_filter name {name!r} is not in the signature "
                    f"outputs {sorted(self.outputs)}")
        arrays = {}
        for alias, spec in self.inputs.items():
            arr = np.asarray(inputs[alias])
            if spec.dtype.is_string:
                raise ServingError.unimplemented(
                    f"input {alias!r}: string tensors are not served by the "
                    "PyTorch port yet")
            try:
                arr = arr.astype(spec.dtype.numpy_dtype, copy=False)
            except (ValueError, TypeError) as exc:
                raise ServingError.invalid_argument(f"input {alias!r}: {exc}")
            spec.validate(arr, alias)
            arrays[alias] = arr
        return arrays

    def run(
        self,
        inputs: Mapping[str, np.ndarray],
        output_filter: Sequence[str] = (),
    ) -> dict[str, np.ndarray]:
        """Validate, pad, place, execute, fetch, slice; alias-keyed numpy
        outputs."""
        arrays = self.validate(inputs, output_filter)
        keys = list(output_filter) if output_filter else list(self.outputs)
        arrays, batch = self._pad_batch(arrays)
        tensors = {alias: _to_device(arr, self.device)
                   for alias, arr in arrays.items()}
        with torch.inference_mode():
            outputs = self.fn(self.params, tensors)
        for key in keys:
            if key not in outputs:
                raise ServingError.internal(
                    f"signature fn did not produce declared output {key!r}")
        return fetch_outputs({k: outputs[k] for k in keys}, batch)

    def _pad_batch(self, arrays: dict[str, np.ndarray]):
        """Pad the shared batch dim up to its bucket with repeats of row 0
        (valid data keeps the model out of NaN paths — the
        batching_session.h:94-99 trick). Returns (arrays, true batch)."""
        batch = next(iter(arrays.values())).shape[0]
        for alias, arr in arrays.items():
            if arr.shape[0] != batch:
                raise ServingError.invalid_argument(
                    f"input {alias!r}: inconsistent batch dim "
                    f"{arr.shape[0]} != {batch}")
        padded = self.round_up_batch(batch)
        if padded != batch:
            arrays = {alias: np.concatenate(
                [arr, np.repeat(arr[:1], padded - batch, axis=0)])
                for alias, arr in arrays.items()}
        return arrays, batch

    def round_up_batch(self, batch: int) -> int:
        """Smallest allowed bucket >= batch (the batch itself past the
        largest)."""
        for bucket in DEFAULT_BATCH_BUCKETS:
            if bucket >= batch:
                return bucket
        return batch

    def to_signature_def(self):
        from min_tfs_client_tpu_torch.protos import tf_graph_pb2

        sig = tf_graph_pb2.SignatureDef(method_name=self.method_name)
        for specs, target in ((self.inputs, sig.inputs),
                              (self.outputs, sig.outputs)):
            for alias, spec in specs.items():
                info = target[alias]
                info.name = f"{alias}:0"
                info.dtype = spec.dtype.enum
                for d in spec.shape:
                    info.tensor_shape.dim.add(size=-1 if d is None else d)
        return sig


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # torch.from_numpy shares memory and refuses read-only buffers (the
    # zero-copy wire decode): copy those once on the host.
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


def fetch_outputs(outputs: Mapping[str, torch.Tensor],
                  batch: int) -> dict[str, np.ndarray]:
    """Device->host for a dict of outputs as one round: every copy is
    issued without blocking, then one synchronisation of the current
    stream. `batch` slices padded leading dims back to the true size."""
    host = {k: v.detach().to("cpu", non_blocking=True)
            for k, v in outputs.items()}
    if any(v.is_cuda for v in outputs.values()):
        torch.cuda.current_stream().synchronize()
    result = {}
    for key, value in host.items():
        arr = value.numpy()
        if arr.ndim:
            arr = arr[:batch]
        result[key] = arr
    return result


class Servable:
    """One loaded model version: named signatures + metadata."""

    def __init__(self, name: str, version: int,
                 signatures: Mapping[str, Signature]):
        if not signatures:
            raise ValueError("servable must expose at least one signature")
        self.name = name
        self.version = version
        self.signatures = dict(signatures)

    def signature(self, name: str = "") -> Signature:
        key = name or DEFAULT_SERVING_SIGNATURE_DEF_KEY
        sig = self.signatures.get(key)
        if sig is None:
            raise ServingError.invalid_argument(
                f"Serving signature key \"{key}\" not found.")
        return sig

    def signature_def_map(self):
        from min_tfs_client_tpu_torch.protos import tfs_apis_pb2

        out = tfs_apis_pb2.SignatureDefMap()
        for key, sig in self.signatures.items():
            out.signature_def[key].CopyFrom(sig.to_signature_def())
        return out
