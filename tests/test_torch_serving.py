"""The port's serving stack (min_tfs_client_tpu_torch: protos, codec,
Signature/Servable, the torch platform, ServerCore, Handlers, LocalServer)
held against the JAX package's on the CPU.

A tiny BERT exported by the JAX package's `export_servable` is served by
both packages' in-process servers from the same directory, and the same
PredictRequest goes to each. Tolerances as in test_torch_bert.py: logits
3e-2, probabilities 1e-2 (bf16 rounding of gelu). GetModelMetadata must be
byte-identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from min_tfs_client_tpu.models import bert as jbert
from min_tfs_client_tpu.models import export as jexport
from min_tfs_client_tpu.protos import tfs_apis_pb2 as japis
from min_tfs_client_tpu.server import local as jlocal
from min_tfs_client_tpu.tensor import codec as jcodec
from min_tfs_client_tpu.tensor import dtypes as jdtypes
from min_tfs_client_tpu_torch.models import bert as tbert
from min_tfs_client_tpu_torch.models import export as texport
from min_tfs_client_tpu_torch.protos import tf_error_pb2
from min_tfs_client_tpu_torch.protos import tfs_apis_pb2 as tapis
from min_tfs_client_tpu_torch.server import local as tlocal
from min_tfs_client_tpu_torch.servables import servable as tservable
from min_tfs_client_tpu_torch.tensor import codec as tcodec
from min_tfs_client_tpu_torch.tensor import dtypes as tdtypes
from min_tfs_client_tpu_torch.utils.status import Code, ServingError

LOGITS_TOL = 3e-2
PROBS_TOL = 1e-2
SEQ = 16
PREDICT = "/tensorflow.serving.PredictionService/Predict"
METADATA = "/tensorflow.serving.PredictionService/GetModelMetadata"
CONFIG = jbert.BertConfig.tiny()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    base = tmp_path_factory.mktemp("serving") / "bert_tiny"
    params = jbert.init_params(jax.random.PRNGKey(0), CONFIG)
    jexport.export_servable(base, 1, "bert", dataclasses.asdict(CONFIG),
                            params, signature_kwargs={
                                "seq_len": SEQ,
                                "class_labels": [b"neg", b"pos"]})
    return base


@pytest.fixture(scope="module")
def servers(exported):
    jax_server = jlocal.boot_local_server(str(exported))
    port_server = tlocal.boot_local_server(str(exported), device="cpu")
    yield jax_server, port_server
    jlocal.shutdown_local_server(str(exported))
    tlocal.shutdown_local_server(str(exported))


def _request(batch, seed=0, name="bert_tiny", **spec):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CONFIG.vocab_size, (batch, SEQ)).astype(np.int32)
    lens = rng.integers(1, SEQ + 1, batch)
    mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
    req = tapis.PredictRequest()
    req.model_spec.name = name
    for key, value in spec.items():
        if key == "version":
            req.model_spec.version.value = value
        else:
            setattr(req.model_spec, key, value)
    req.inputs["input_ids"].CopyFrom(tcodec.ndarray_to_tensor_proto(ids))
    req.inputs["attention_mask"].CopyFrom(tcodec.ndarray_to_tensor_proto(mask))
    return req


def test_protos_are_shared_with_the_jax_package():
    assert tapis.PredictRequest is japis.PredictRequest


@pytest.mark.parametrize("batch", [1, 3, 4])
@pytest.mark.parametrize("signature_name", ["", "predict"])
def test_predict_matches_jax_server(servers, batch, signature_name):
    jax_server, port_server = servers
    req = _request(batch, seed=batch, signature_name=signature_name)
    want = jax_server.invoke(PREDICT, req)
    got = port_server.invoke(PREDICT, req)
    assert got.model_spec == want.model_spec
    assert sorted(got.outputs) == sorted(want.outputs)
    for alias, tol in (("logits", LOGITS_TOL), ("probabilities", PROBS_TOL)):
        w = jcodec.tensor_proto_to_ndarray(want.outputs[alias])
        g = tcodec.tensor_proto_to_ndarray(got.outputs[alias])
        assert g.shape == w.shape == (batch, CONFIG.num_labels)
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=tol, rtol=0)


def test_output_filter_matches_jax_server(servers):
    jax_server, port_server = servers
    req = _request(2)
    req.output_filter.append("probabilities")
    assert list(port_server.invoke(PREDICT, req).outputs) == list(
        jax_server.invoke(PREDICT, req).outputs) == ["probabilities"]


def test_metadata_bytes_identical(servers):
    jax_server, port_server = servers
    req = japis.GetModelMetadataRequest()
    req.model_spec.name = "bert_tiny"
    req.metadata_field.append("signature_def")
    want = jax_server.invoke(METADATA, req).SerializeToString(
        deterministic=True)
    got = port_server.invoke(METADATA, req).SerializeToString(
        deterministic=True)
    assert got == want


@pytest.mark.parametrize("case", ["unknown_model", "unknown_version",
                                  "version_label", "missing_input",
                                  "bad_output_filter", "bad_shape",
                                  "unknown_signature", "no_metadata_field"])
def test_errors_match_jax_server(servers, case):
    jax_server, port_server = servers
    method = PREDICT
    if case == "unknown_model":
        req = _request(1, name="nope")
    elif case == "unknown_version":
        req = _request(1, version=7)
    elif case == "version_label":
        req = _request(1, version_label="stable")
    elif case == "missing_input":
        req = _request(1)
        del req.inputs["attention_mask"]
    elif case == "bad_output_filter":
        req = _request(1)
        req.output_filter.append("nope")
    elif case == "bad_shape":
        req = _request(1)
        req.inputs["input_ids"].CopyFrom(tcodec.ndarray_to_tensor_proto(
            np.zeros((1, SEQ + 1), np.int32)))
    elif case == "unknown_signature":
        req = _request(1, signature_name="nope")
    else:
        method = METADATA
        req = japis.GetModelMetadataRequest()
        req.model_spec.name = "bert_tiny"
    with pytest.raises(Exception) as jax_err:
        jax_server.invoke(method, req)
    with pytest.raises(ServingError) as port_err:
        port_server.invoke(method, req)
    assert int(port_err.value.code) == jax_err.value.code().value[0]
    assert port_err.value.message == jax_err.value.details()


def test_batch_three_pads_to_bucket_four_with_row_zero(exported):
    sigs = texport.load_signatures(exported / "1", device="cpu")
    sig = sigs["serving_default"]
    assert sig.round_up_batch(3) == 4
    seen = {}
    inner = sig.fn

    def spy(params, inputs):
        seen.update({k: v.clone() for k, v in inputs.items()})
        return inner(params, inputs)

    sig.fn = spy
    req = _request(3, seed=5)
    inputs = tcodec.tensor_protos_to_dict(req.inputs)
    out = sig.run(inputs)
    assert out["logits"].shape == (3, CONFIG.num_labels)
    for alias, arr in inputs.items():
        assert seen[alias].shape == (4, SEQ)
        np.testing.assert_array_equal(seen[alias][:3].numpy(), arr)
        np.testing.assert_array_equal(seen[alias][3].numpy(), arr[0])


def test_unported_apis_are_unimplemented(servers):
    _, port_server = servers
    req = japis.ClassificationRequest()
    req.model_spec.name = "bert_tiny"
    for method in ("/tensorflow.serving.PredictionService/Classify",
                   "/tensorflow.serving.PredictionService/Regress",
                   "/tensorflow.serving.PredictionService/Bogus"):
        with pytest.raises(ServingError) as err:
            port_server.invoke(method, req)
        assert err.value.code == Code.UNIMPLEMENTED


def test_written_dir_loads_in_both_packages(tmp_path):
    config = jbert.BertConfig.tiny(num_layers=1)
    tree = tbert.init_params(np.random.default_rng(4), config)
    base = tmp_path / "bert_written"
    vdir = texport.write_version_dir(
        base, 3, dataclasses.asdict(config), texport.flatten_params(tree),
        {"seq_len": SEQ})
    assert sorted(p.name for p in vdir.iterdir()) == [
        "config.json", "params.npz", "servable.py"]
    assert json.loads((vdir / "config.json").read_text())["family"] == "bert"
    jax_sigs = jexport.load_signatures(vdir)
    inputs = tcodec.tensor_protos_to_dict(_request(2, seed=6).inputs)
    want = jax_sigs["serving_default"].run(dict(inputs))
    server = tlocal.boot_local_server(str(base), device="cpu")
    try:
        sig = server.core.servable_handle(
            _request(1, name="bert_written").model_spec).signature()
        got = sig.run(inputs)
    finally:
        assert tlocal.shutdown_local_server(str(base))
    np.testing.assert_allclose(got["logits"], want["logits"],
                               atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("key", ["quantize", "sharding", "pipeline",
                                 "family"])
def test_unserved_config_is_refused(exported, tmp_path, key):
    base = tmp_path / "refused"
    vdir = base / "1"
    vdir.mkdir(parents=True)
    meta = json.loads((exported / "1" / "config.json").read_text())
    if key == "family":
        meta["family"] = "t5"
    else:
        meta[key] = {"quantize": "int8", "sharding": {"axes": {"model": 2}},
                     "pipeline": {"stages": 2}}[key]
    (vdir / "config.json").write_text(json.dumps(meta))
    (vdir / "params.npz").write_bytes(
        (exported / "1" / "params.npz").read_bytes())
    with pytest.raises(NotImplementedError, match="slice"):
        tlocal.boot_local_server(str(base), device="cpu")


def test_quantized_export_is_refused(tmp_path):
    params = jbert.init_params(jax.random.PRNGKey(1), CONFIG)
    base = tmp_path / "bert_int8"
    jexport.export_servable(base, 1, "bert", dataclasses.asdict(CONFIG),
                            params, signature_kwargs={"seq_len": SEQ},
                            quantize="int8")
    with pytest.raises(NotImplementedError, match="quantize"):
        tlocal.boot_local_server(str(base), device="cpu")


def test_boot_serves_the_newest_version(exported, tmp_path):
    base = tmp_path / "two_versions"
    for version in (2, 10):
        dst = base / str(version)
        dst.mkdir(parents=True)
        for name in ("config.json", "params.npz"):
            (dst / name).write_bytes((exported / "1" / name).read_bytes())
    server = tlocal.boot_local_server(str(base), device="cpu")
    try:
        resp = server.invoke(PREDICT, _request(1, name="two_versions"))
        assert resp.model_spec.version.value == 10
        with pytest.raises(ServingError) as err:
            server.invoke(PREDICT, _request(1, name="two_versions", version=2))
        assert err.value.code == Code.NOT_FOUND
    finally:
        tlocal.shutdown_local_server(str(base))
    assert not tlocal.shutdown_local_server(str(base))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "int8", "uint8", "bool", "float16",
                                   "complex64", "object"])
@pytest.mark.parametrize("content", [True, False])
def test_codec_bytes_match_jax(dtype, content):
    rng = np.random.default_rng(0)
    if dtype == "object":
        arr = np.asarray([[b"a", b"bc"], [b"", b"xyz"]], dtype=object)
    elif dtype == "bool":
        arr = rng.integers(0, 2, (2, 3)).astype(bool)
    elif dtype == "complex64":
        arr = (rng.standard_normal((2, 3))
               + 1j * rng.standard_normal((2, 3))).astype(np.complex64)
    else:
        arr = (rng.standard_normal((2, 3)) * 50).astype(dtype)
    want = jcodec.ndarray_to_tensor_proto(arr, use_tensor_content=content)
    got = tcodec.ndarray_to_tensor_proto(arr, use_tensor_content=content)
    assert got.SerializeToString() == want.SerializeToString()
    back = tcodec.tensor_proto_to_ndarray(want)
    np.testing.assert_array_equal(back, jcodec.tensor_proto_to_ndarray(want))


def test_bfloat16_wire_tensor_is_invalid_argument():
    proto = jcodec.ndarray_to_tensor_proto(
        np.asarray(jnp.ones((2,), jnp.bfloat16)), use_tensor_content=False)
    with pytest.raises(ServingError) as err:
        tcodec.tensor_proto_to_ndarray(proto)
    assert err.value.code == Code.INVALID_ARGUMENT


def test_dtype_table_matches_jax():
    assert tdtypes.all_supported() == jdtypes.all_supported()
    for name in jdtypes.all_supported():
        want, got = jdtypes.DataType(name), tdtypes.DataType(name)
        assert got.enum == want.enum
        assert got.proto_field_name == want.proto_field_name
        if name != "DT_BFLOAT16":
            assert got.numpy_dtype == want.numpy_dtype


def test_status_codes_match_tf_error_proto():
    for code in Code:
        assert tf_error_pb2.Code.Value(code.name) == int(code)
    assert set(tf_error_pb2.Code.keys()) >= {code.name for code in Code}
    err = ServingError.not_found("x")
    assert err.code == Code.NOT_FOUND and str(err) == "NOT_FOUND: x"


def test_signature_fetches_only_requested_outputs(exported):
    sig = texport.load_signatures(exported / "1",
                                  device="cpu")["serving_default"]
    inputs = tcodec.tensor_protos_to_dict(_request(2).inputs)
    out = sig.run(inputs, ("logits",))
    assert list(out) == ["logits"]
    assert isinstance(out["logits"], np.ndarray)
    assert sig.device == torch.device("cpu")


def test_signature_validates_like_jax():
    spec = tservable.TensorSpec(np.int32, (None, 4))
    with pytest.raises(ServingError, match="expected rank 2"):
        spec.validate(np.zeros((4,), np.int32), "x")
    sig = tservable.Signature(fn=lambda params, inputs: {"y": inputs["x"] * 2},
                              inputs={"x": spec},
                              outputs={"y": tservable.TensorSpec(np.int32)},
                              device="cpu")
    out = sig.run({"x": np.arange(20, dtype=np.int64).reshape(5, 4)})
    assert out["y"].dtype == np.int32 and out["y"].shape == (5, 4)
    assert sig.round_up_batch(5) == 8 and sig.round_up_batch(300) == 300
