"""The PyTorch port stands alone: it imports nothing of JAX, ml_dtypes,
grpc or the JAX package, calls no library attention kernel and no
torch.compile, loads without protobuf, and serves on the CPU only when
asked to."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "min_tfs_client_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "grpc", "min_tfs_client_tpu"}

PORT_FILES = sorted(PORT.rglob("*.py"))
SERVING_MODULES = [
    "min_tfs_client_tpu_torch.server.local",
    "min_tfs_client_tpu_torch.server.handlers",
    "min_tfs_client_tpu_torch.core.server_core",
    "min_tfs_client_tpu_torch.servables.platforms",
    "min_tfs_client_tpu_torch.models.export",
    "min_tfs_client_tpu_torch.models.bert",
    "min_tfs_client_tpu_torch.ops.attention",
    "min_tfs_client_tpu_torch.tensor.codec",
]


def _top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_has_files():
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    # Exact top-level names: "min_tfs_client_tpu_torch" starts with
    # "min_tfs_client_tpu" but is the port itself.
    assert not _top_level_imports(path) & FORBIDDEN


def test_serving_modules_load_without_jax_grpc_or_ml_dtypes():
    # A fresh interpreter: this test process has JAX loaded (conftest).
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {SERVING_MODULES!r}:
            importlib.import_module(name)
        loaded = {{m.split(".")[0] for m in sys.modules}}
        bad = loaded & set({sorted(FORBIDDEN)!r})
        assert not bad, bad
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_serving_runs_without_protobuf(tmp_path):
    """Only the wire (protos, codec, handlers) needs protobuf: a version
    directory still loads and a signature runs with it unimportable."""
    code = textwrap.dedent(f"""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name == "google.protobuf" or name.startswith(
                        "google.protobuf."):
                    raise ImportError("blocked: " + name)

        sys.meta_path.insert(0, Block())
        import numpy as np
        from min_tfs_client_tpu_torch.models import bert, export
        from min_tfs_client_tpu_torch.server import local
        config = bert.BertConfig.tiny(num_layers=1)
        tree = bert.init_params(np.random.default_rng(0), config)
        export.write_version_dir({str(tmp_path / "m")!r}, 1,
                                 {{"num_layers": 1, "vocab_size": 128,
                                   "hidden_size": 32, "num_heads": 2,
                                   "intermediate_size": 64,
                                   "max_position": 64}},
                                 export.flatten_params(tree),
                                 {{"seq_len": 8}})
        server = local.boot_local_server({str(tmp_path / "m")!r},
                                         device="cpu")
        sig = server.core.servable.signature()
        out = sig.run({{"input_ids": np.ones((2, 8), np.int32),
                        "attention_mask": np.ones((2, 8), np.int32)}})
        assert out["logits"].shape == (2, 2), out
        assert "google.protobuf" not in sys.modules
    """)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_boot_without_device_needs_cuda(tmp_path):
    from min_tfs_client_tpu_torch.server import local

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local.boot_local_server(str(tmp_path))


def _entry_points():
    from min_tfs_client_tpu_torch.models import bert, export
    from min_tfs_client_tpu_torch.servables import servable

    config = bert.BertConfig.tiny()
    return {
        "params_from_jax": lambda path: export.params_from_jax({}, config),
        "load_signatures": lambda path: export.load_signatures(path),
        "build_family_signatures": lambda path:
            export.build_family_signatures("bert", {}, {}, {}),
        "build_signatures": lambda path:
            bert.build_signatures({}, config, seq_len=8),
        "Signature": lambda path: servable.Signature(
            fn=lambda params, inputs: inputs, inputs={}, outputs={}),
    }


@pytest.mark.parametrize("name", ["params_from_jax", "load_signatures",
                                  "build_family_signatures",
                                  "build_signatures", "Signature"])
def test_entry_point_without_device_needs_cuda(tmp_path, name):
    """Every entry point that places work defaults to the card, as
    boot_local_server does: without one it raises, never serves on the
    CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name](tmp_path)


@pytest.mark.parametrize("needle", ["scaled_dot_product_attention",
                                    "torch.compile", "flash_attn",
                                    "cudnn"])
def test_no_library_attention_or_compile(needle):
    hits = [str(p.relative_to(REPO)) for p in PORT_FILES + sorted(
        PORT.rglob("*.cu")) if needle in p.read_text()]
    assert not hits
