"""ServerCore, reduced: one model served from a base path.

Counterpart of `min_tfs_client_tpu/core/server_core.py` for the port's
first slice. It loads one version of one model at construction — the
newest numeric version directory under the base path — and hands it to
requests through `servable_handle(model_spec)`,
with the JAX package's error semantics: a missing name is
INVALID_ARGUMENT, an unknown model or version NOT_FOUND, an unknown
version label INVALID_ARGUMENT. File-system polling, the aspired-versions
manager and reload come with a later slice.
"""

from __future__ import annotations

import pathlib
from typing import Optional

from min_tfs_client_tpu_torch.servables import platforms
from min_tfs_client_tpu_torch.servables.servable import Servable
from min_tfs_client_tpu_torch.utils.status import ServingError


def list_version_dirs(base_path) -> list[tuple[int, str]]:
    """Numeric children of base_path, as (version, path), ascending."""
    base = pathlib.Path(base_path)
    if not base.is_dir():
        return []
    return sorted((int(child.name), str(child)) for child in base.iterdir()
                  if child.is_dir() and child.name.isdigit())


class ServerCore:
    def __init__(self, name: str, base_path: str, *, device):
        versions = dict(list_version_dirs(base_path))
        if not versions:
            raise ServingError.not_found(
                f"no version directories under {base_path} for model {name}")
        version = max(versions)
        self.name = name
        self.device = device
        # The loaded version; None once stopped.
        self.servable: Optional[Servable] = platforms.load_servable(
            name, version, versions[version], device)

    def resolve_version(self, model_spec) -> Optional[int]:
        choice = model_spec.WhichOneof("version_choice")
        if choice == "version":
            return model_spec.version.value
        if choice == "version_label":
            # No labels are configured on a single-model core.
            raise ServingError.invalid_argument(
                f"Requested version label: {model_spec.version_label} for "
                f"model: {model_spec.name} does not exist")
        return None

    def servable_handle(self, model_spec) -> Servable:
        """The loaded version the spec names. Nothing unloads it while a
        request runs: only stop() drops it."""
        if not model_spec.name:
            raise ServingError.invalid_argument("Missing ModelSpec.name")
        version = self.resolve_version(model_spec)
        servable = self.servable
        if servable is None or model_spec.name != self.name:
            raise ServingError.not_found(
                f"Servable not found for request: {model_spec.name}")
        if version is not None and version != servable.version:
            raise ServingError.not_found(
                f"Servable not found for request: {model_spec.name} "
                f"version {version}")
        return servable

    def stop(self) -> None:
        """Drop the servable (and with it the device memory it holds)."""
        self.servable = None
