"""The port's platform loader.

The JAX package keeps a registry of platforms ("tensorflow", "jax"); the
port has one, "torch": a version directory holding config.json +
params.npz (the JAX package's native export layout), loaded by
models/export.py onto the server's device. It never executes the
directory's servable.py, which imports the JAX package's loader.
"""

from __future__ import annotations

from min_tfs_client_tpu_torch.servables.servable import Servable

PLATFORM = "torch"


def load_servable(name: str, version: int, path: str, device) -> Servable:
    from min_tfs_client_tpu_torch.models.export import load_signatures

    return Servable(name, version, load_signatures(path, device=device))
