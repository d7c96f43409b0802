"""Transport-independent request handlers.

Counterpart of `min_tfs_client_tpu/server/handlers.py` for the port's
first slice: Predict (predict_util.cc:89-215 semantics: signature lookup,
alias-keyed inputs, output_filter, the effective model_spec in the
response) and GetModelMetadata (signature_def only). Classify, Regress,
MultiInference and SessionRun answer UNIMPLEMENTED until Example decoding
and graph import are ported; GetModelStatus and ReloadConfig until the
lifecycle manager is.
"""

from __future__ import annotations

from min_tfs_client_tpu_torch.core.server_core import ServerCore
from min_tfs_client_tpu_torch.tensor.codec import (
    ndarray_to_tensor_proto,
    tensor_protos_to_dict,
)
from min_tfs_client_tpu_torch.utils.status import ServingError

SIGNATURE_DEF_METADATA_FIELD = "signature_def"


def _effective_spec(target, model_spec, version: int,
                    signature_name: str) -> None:
    target.name = model_spec.name
    target.version.value = version
    if signature_name:
        target.signature_name = signature_name


def _unimplemented(api: str, later: str):
    def handler(request):
        raise ServingError.unimplemented(
            f"{api} is not served by the PyTorch port yet; it comes with "
            f"{later}")
    return handler


class Handlers:
    def __init__(self, core: ServerCore):
        self.core = core
        examples = "the port's Example decoding (ROADMAP Queue 1, item 6)"
        lifecycle = "the port's lifecycle manager (ROADMAP Queue 1, item 6)"
        self.classify = _unimplemented("Classify", examples)
        self.regress = _unimplemented("Regress", examples)
        self.multi_inference = _unimplemented("MultiInference", examples)
        self.session_run = _unimplemented(
            "SessionRun", "imported graphs (ROADMAP Queue 1, item 12)")
        self.get_model_status = _unimplemented("GetModelStatus", lifecycle)
        self.handle_reload_config = _unimplemented("ReloadConfig", lifecycle)

    def predict(self, request):
        from min_tfs_client_tpu_torch.protos import tfs_apis_pb2 as apis

        servable = self.core.servable_handle(request.model_spec)
        signature = servable.signature(request.model_spec.signature_name)
        inputs = tensor_protos_to_dict(request.inputs, writable=False)
        outputs = signature.run(inputs, tuple(request.output_filter))
        response = apis.PredictResponse()
        _effective_spec(response.model_spec, request.model_spec,
                        servable.version, request.model_spec.signature_name)
        # Packed tensor_content, as the JAX package's in-process server
        # answers.
        for alias, arr in outputs.items():
            response.outputs[alias].CopyFrom(ndarray_to_tensor_proto(arr))
        return response

    def get_model_metadata(self, request):
        from min_tfs_client_tpu_torch.protos import tfs_apis_pb2 as apis

        if not request.metadata_field:
            raise ServingError.invalid_argument(
                "GetModelMetadataRequest must specify at least one "
                "metadata_field")
        for field in request.metadata_field:
            if field != SIGNATURE_DEF_METADATA_FIELD:
                raise ServingError.invalid_argument(
                    f"Metadata field {field} is not supported")
        servable = self.core.servable_handle(request.model_spec)
        response = apis.GetModelMetadataResponse()
        response.model_spec.name = request.model_spec.name
        response.model_spec.version.value = servable.version
        response.metadata[SIGNATURE_DEF_METADATA_FIELD].Pack(
            servable.signature_def_map())
        return response
