"""In-process serving: a LocalServer answers TF-Serving method paths in the
caller's process, on the card.

Counterpart of `min_tfs_client_tpu/server/local.py`. `invoke(method,
request)` routes the same method paths onto the handlers; failures raise
the port's `ServingError` (with the JAX package's exception-to-code
mapping) rather than a `grpc.RpcError`, since the port does not depend on
grpcio.
"""

from __future__ import annotations

import pathlib
import threading
from typing import Optional

from min_tfs_client_tpu_torch.core.server_core import ServerCore
from min_tfs_client_tpu_torch.server.handlers import Handlers
from min_tfs_client_tpu_torch.utils.device import resolve_device
from min_tfs_client_tpu_torch.utils.status import (
    ServingError,
    error_from_exception,
)


class LocalServer:
    """Dispatches TF-Serving method paths onto Handlers, in-process."""

    def __init__(self, core: ServerCore):
        self.core = core
        handlers = Handlers(core)
        self._routes = {
            "/tensorflow.serving.PredictionService/Predict": handlers.predict,
            "/tensorflow.serving.PredictionService/Classify": handlers.classify,
            "/tensorflow.serving.PredictionService/Regress": handlers.regress,
            "/tensorflow.serving.PredictionService/MultiInference":
                handlers.multi_inference,
            "/tensorflow.serving.PredictionService/GetModelMetadata":
                handlers.get_model_metadata,
            "/tensorflow.serving.SessionService/SessionRun":
                handlers.session_run,
            "/tensorflow.serving.ModelService/GetModelStatus":
                handlers.get_model_status,
            "/tensorflow.serving.ModelService/HandleReloadConfigRequest":
                handlers.handle_reload_config,
        }

    def invoke(self, method: str, request, timeout: Optional[float] = None):
        handler = self._routes.get(method)
        if handler is None:
            raise ServingError.unimplemented(method)
        try:
            return handler(request)
        except ServingError:
            raise
        except Exception as exc:  # mapped onto a status code, as on the wire
            raise error_from_exception(exc) from exc

    def stop(self) -> None:
        self.core.stop()


_registry_lock = threading.Lock()
_registry: dict[str, LocalServer] = {}


def _key(base_path) -> str:
    return str(base_path).rstrip("/")


def boot_local_server(base_path: str, device=None) -> LocalServer:
    """Serve the latest version under `base_path` (a model directory of
    numbered version dirs; its basename is the model name) in-process on
    `device` (default: the CUDA card)."""
    device = resolve_device(device)
    path = pathlib.Path(base_path)
    server = LocalServer(ServerCore(path.name, str(path), device=device))
    with _registry_lock:
        previous = _registry.pop(_key(base_path), None)
        _registry[_key(base_path)] = server
    if previous is not None:
        previous.stop()
    return server


def shutdown_local_server(base_path: str) -> bool:
    """Stop and unregister the in-process server for ``base_path``; False
    when none is registered."""
    with _registry_lock:
        server = _registry.pop(_key(base_path), None)
    if server is None:
        return False
    server.stop()
    return True
