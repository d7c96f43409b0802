"""Version directories: load side, and a writer of the same layout.

The JAX package's `export_servable` (models/export.py:103-198) writes

    <base_path>/<version>/
        servable.py    loader stub for the JAX package's "jax" platform
        config.json    {"family", "config", "signature_kwargs"}
        params.npz     flattened param tree ("layers.0.mlp.wi.kernel", ...)

The port serves such a directory unchanged: it reads config.json and
params.npz and never executes servable.py (the stub imports the JAX
loader). `write_version_dir` writes the same layout without JAX.
"""

from __future__ import annotations

import json
import pathlib
from typing import Mapping

import numpy as np
import torch

from min_tfs_client_tpu_torch.models import bert
from min_tfs_client_tpu_torch.models import layers as nn
from min_tfs_client_tpu_torch.utils.device import resolve_device

# Written verbatim by the JAX package's export_servable; kept so a directory
# written here also loads on the JAX package's "jax" platform.
_SERVABLE_STUB = """\
# Auto-generated by min_tfs_client_tpu.models.export — loads a native
# model-family servable from this directory's config.json + params.npz.
def build(path):
    from min_tfs_client_tpu.models.export import load_signatures

    return load_signatures(path)
"""

# config.json keys the JAX package honours that this slice does not serve:
# refused, never ignored.
_UNSUPPORTED_KEYS = {
    "quantize": "int8 weight-only serving comes with the port's slice B "
                "(ROADMAP Queue 1, item 9)",
    "sharding": "tensor-parallel sharding comes with the port's parallel/ "
                "slice (ROADMAP Queue 1, item 14)",
    "pipeline": "pipeline-parallel serving comes with the port's parallel/ "
                "slice (ROADMAP Queue 1, item 14)",
}

_LATER_FAMILIES = {
    "t5": "slice C (ROADMAP Queue 1, item 10)",
    "resnet": "slice B (ROADMAP Queue 1, item 7)",
    "use": "slice B (ROADMAP Queue 1, item 8)",
}


# -- param tree <-> npz --------------------------------------------------------


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a.0.b": leaf}, the JAX package's key form."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for key, value in items:
        flat.update(flatten_params(
            value, f"{prefix}.{key}" if prefix else str(key)))
    return flat


def unflatten_params(flat: Mapping[str, object]):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return _listify(root)


def _listify(node):
    """Dicts whose keys are exactly 0..n-1 were lists before flattening."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        indices = sorted(int(k) for k in out)
        if indices == list(range(len(indices))):
            return [out[str(i)] for i in indices]
    return out


def _restore(arr: np.ndarray) -> torch.Tensor:
    # npz stores bfloat16 as raw void16 pairs: view the bits through int16.
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load_params(path):
    """params.npz -> the JAX package's nested tree, as CPU tensors."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten_params({k: _restore(data[k]) for k in data.files})


# -- load ------------------------------------------------------------------------


def _tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    if not isinstance(value, torch.Tensor):
        value = torch.tensor(np.asarray(value))  # copies: inputs may be read-only
    return value.to(device=device, dtype=dtype)


def params_from_jax(tree: Mapping, config: bert.BertConfig, *,
                    device=None) -> dict:
    """The JAX package's BERT parameter tree (nested dicts/lists of numpy
    arrays or CPU tensors: its bert.init_params, or unflatten_params of a
    params.npz) -> the port's tree on `device` (None: the CUDA card). Leaves
    get the dtype their consumer computes in, once: dense kernels/biases and
    embedding tables bf16 (the JAX package casts them on every call),
    LayerNorm f32."""
    device = resolve_device(device)
    layers = tree["layers"]
    if config.moe_experts or any("moe" in layer for layer in layers):
        raise NotImplementedError(f"BERT Switch-MoE {bert.PARALLEL_SLICE}")
    if len(layers) != config.num_layers:
        raise ValueError(f"params hold {len(layers)} layers, config "
                         f"{config.num_layers}")

    def dense(p):
        return {k: _tensor(p[k], nn.COMPUTE_DTYPE, device)
                for k in ("kernel", "bias")}

    def norm(p):
        return {k: _tensor(p[k], torch.float32, device)
                for k in ("scale", "bias")}

    def embed(p):
        return {"embedding": _tensor(p["embedding"], nn.COMPUTE_DTYPE, device)}

    emb = tree["embeddings"]
    return {
        "embeddings": {"word": embed(emb["word"]),
                       "position": embed(emb["position"]),
                       "token_type": embed(emb["token_type"]),
                       "norm": norm(emb["norm"])},
        "layers": [{
            "attention": {name: dense(layer["attention"][name])
                          for name in ("query", "key", "value", "out")},
            "attention_norm": norm(layer["attention_norm"]),
            "mlp_norm": norm(layer["mlp_norm"]),
            "mlp": {name: dense(layer["mlp"][name]) for name in ("wi", "wo")},
        } for layer in layers],
        "pooler": dense(tree["pooler"]),
        "head": dense(tree["head"]),
    }


def read_config(path) -> dict:
    """config.json of a version directory, refusing what this slice does
    not serve."""
    meta = json.loads((pathlib.Path(path) / "config.json").read_text())
    for key, why in _UNSUPPORTED_KEYS.items():
        if meta.get(key):
            raise NotImplementedError(
                f"{path}: config.json asks for {key!r}; {why}")
    return meta


def load_signatures(path, *, device=None) -> dict:
    """A version directory's signatures on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    vdir = pathlib.Path(path)
    meta = read_config(vdir)
    params = load_params(vdir / "params.npz")
    return build_family_signatures(
        meta["family"], meta.get("config", {}),
        dict(meta.get("signature_kwargs", {})), params, device=device)


def build_family_signatures(family, config_kwargs, sig_kwargs, params, *,
                            device=None) -> dict:
    """Family dispatch: `params` is the JAX package's tree (numpy arrays or
    CPU tensors), carried onto `device` (None: the CUDA card) by the
    family's params_from_jax."""
    device = resolve_device(device)
    if family != "bert":
        later = _LATER_FAMILIES.get(family)
        raise NotImplementedError(
            f"model family {family!r} is not served by the PyTorch port "
            "yet" + (f"; it comes with {later}" if later else ""))
    sig_kwargs = dict(sig_kwargs)
    if sig_kwargs.get("class_labels"):
        sig_kwargs["class_labels"] = [
            label.encode() for label in sig_kwargs["class_labels"]]
    config = bert.BertConfig(**config_kwargs)
    port_params = params_from_jax(params, config, device=device)
    return bert.build_signatures(port_params, config, device=device,
                                 **sig_kwargs)


# -- write -----------------------------------------------------------------------


def write_version_dir(base_path, version: int, config_kwargs: dict,
                      flat_params: Mapping[str, np.ndarray],
                      signature_kwargs: dict | None = None) -> pathlib.Path:
    """Write a BERT version directory in export_servable's exact layout
    (config.json, params.npz of `flat_params` as flatten_params keys them,
    servable.py), loadable by both packages. Returns the directory."""
    sig_kwargs = dict(signature_kwargs or {})
    if sig_kwargs.get("class_labels"):
        sig_kwargs["class_labels"] = [
            label.decode("utf-8") if isinstance(label, bytes) else str(label)
            for label in sig_kwargs["class_labels"]]
    meta = {"family": "bert", "config": config_kwargs,
            "signature_kwargs": sig_kwargs}
    vdir = pathlib.Path(base_path) / str(version)
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "config.json").write_text(json.dumps(meta, indent=2))
    np.savez(vdir / "params.npz", **flat_params)
    (vdir / "servable.py").write_text(_SERVABLE_STUB)
    return vdir
