# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: min_tfs_client_tpu/protos/tfs_apis.proto
"""Generated protocol buffer code."""
# Port copy: only the `from ... import` lines differ from the JAX package's
# file. The 'min_tfs_client_tpu/protos/*.proto' strings inside the
# serialized descriptor are descriptor file names, not imports; they stay
# byte-identical so both packages can share protobuf's default pool.
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import any_pb2 as google_dot_protobuf_dot_any__pb2
from google.protobuf import wrappers_pb2 as google_dot_protobuf_dot_wrappers__pb2
from min_tfs_client_tpu_torch.protos import tf_tensor_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__tensor__pb2
from min_tfs_client_tpu_torch.protos import tf_example_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__example__pb2
from min_tfs_client_tpu_torch.protos import tf_error_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__error__pb2
from min_tfs_client_tpu_torch.protos import tf_graph_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__graph__pb2
from min_tfs_client_tpu_torch.protos import tf_config_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__config__pb2
from min_tfs_client_tpu_torch.protos import tfs_config_pb2 as min__tfs__client__tpu_dot_protos_dot_tfs__config__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n(min_tfs_client_tpu/protos/tfs_apis.proto\x12\x12tensorflow.serving\x1a\x19google/protobuf/any.proto\x1a\x1egoogle/protobuf/wrappers.proto\x1a)min_tfs_client_tpu/protos/tf_tensor.proto\x1a*min_tfs_client_tpu/protos/tf_example.proto\x1a(min_tfs_client_tpu/protos/tf_error.proto\x1a(min_tfs_client_tpu/protos/tf_graph.proto\x1a)min_tfs_client_tpu/protos/tf_config.proto\x1a*min_tfs_client_tpu/protos/tfs_config.proto\"k\n\x0bStatusProto\x12\x36\n\nerror_code\x18\x01 \x01(\x0e\x32\x16.tensorflow.error.CodeR\nerror_code\x12$\n\rerror_message\x18\x02 \x01(\tR\rerror_message\"\x8c\x01\n\tModelSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12.\n\x07version\x18\x02 \x01(\x0b\x32\x1b.google.protobuf.Int64ValueH\x00\x12\x17\n\rversion_label\x18\x04 \x01(\tH\x00\x12\x16\n\x0esignature_name\x18\x03 \x01(\tB\x10\n\x0eversion_choice\"\xe2\x01\n\x0ePredictRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12>\n\x06inputs\x18\x02 \x03(\x0b\x32..tensorflow.serving.PredictRequest.InputsEntry\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1a\x46\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.tensorflow.TensorProto:\x02\x38\x01\"\xd0\x01\n\x0fPredictResponse\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x41\n\x07outputs\x18\x01 \x03(\x0b\x32\x30.tensorflow.serving.PredictResponse.OutputsEntry\x1aG\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.tensorflow.TensorProto:\x02\x38\x01\"4\n\x0b\x45xampleList\x12%\n\x08\x65xamples\x18\x01 \x03(\x0b\x32\x13.tensorflow.Example\"e\n\x16\x45xampleListWithContext\x12%\n\x08\x65xamples\x18\x01 \x03(\x0b\x32\x13.tensorflow.Example\x12$\n\x07\x63ontext\x18\x02 \x01(\x0b\x32\x13.tensorflow.Example\"\x99\x01\n\x05Input\x12\x37\n\x0c\x65xample_list\x18\x01 \x01(\x0b\x32\x1f.tensorflow.serving.ExampleListH\x00\x12O\n\x19\x65xample_list_with_context\x18\x02 \x01(\x0b\x32*.tensorflow.serving.ExampleListWithContextH\x00\x42\x06\n\x04kind\"%\n\x05\x43lass\x12\r\n\x05label\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x02\"=\n\x0f\x43lassifications\x12*\n\x07\x63lasses\x18\x01 \x03(\x0b\x32\x19.tensorflow.serving.Class\"T\n\x14\x43lassificationResult\x12<\n\x0f\x63lassifications\x18\x01 \x03(\x0b\x32#.tensorflow.serving.Classifications\"t\n\x15\x43lassificationRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"\x85\x01\n\x16\x43lassificationResponse\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x38\n\x06result\x18\x01 \x01(\x0b\x32(.tensorflow.serving.ClassificationResult\"\x1b\n\nRegression\x12\r\n\x05value\x18\x01 \x01(\x02\"G\n\x10RegressionResult\x12\x33\n\x0bregressions\x18\x01 \x03(\x0b\x32\x1e.tensorflow.serving.Regression\"p\n\x11RegressionRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"}\n\x12RegressionResponse\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x34\n\x06result\x18\x01 \x01(\x0b\x32$.tensorflow.serving.RegressionResult\"W\n\rInferenceTask\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x13\n\x0bmethod_name\x18\x02 \x01(\t\"\xdc\x01\n\x0fInferenceResult\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12I\n\x15\x63lassification_result\x18\x02 \x01(\x0b\x32(.tensorflow.serving.ClassificationResultH\x00\x12\x41\n\x11regression_result\x18\x03 \x01(\x0b\x32$.tensorflow.serving.RegressionResultH\x00\x42\x08\n\x06result\"s\n\x15MultiInferenceRequest\x12\x30\n\x05tasks\x18\x01 \x03(\x0b\x32!.tensorflow.serving.InferenceTask\x12(\n\x05input\x18\x02 \x01(\x0b\x32\x19.tensorflow.serving.Input\"N\n\x16MultiInferenceResponse\x12\x34\n\x07results\x18\x01 \x03(\x0b\x32#.tensorflow.serving.InferenceResult\"\xae\x01\n\x0fSignatureDefMap\x12L\n\rsignature_def\x18\x01 \x03(\x0b\x32\x35.tensorflow.serving.SignatureDefMap.SignatureDefEntry\x1aM\n\x11SignatureDefEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\'\n\x05value\x18\x02 \x01(\x0b\x32\x18.tensorflow.SignatureDef:\x02\x38\x01\"d\n\x17GetModelMetadataRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x16\n\x0emetadata_field\x18\x02 \x03(\t\"\xe2\x01\n\x18GetModelMetadataResponse\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12L\n\x08metadata\x18\x02 \x03(\x0b\x32:.tensorflow.serving.GetModelMetadataResponse.MetadataEntry\x1a\x45\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12#\n\x05value\x18\x02 \x01(\x0b\x32\x14.google.protobuf.Any:\x02\x38\x01\"J\n\x15GetModelStatusRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"\xe8\x01\n\x12ModelVersionStatus\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12;\n\x05state\x18\x02 \x01(\x0e\x32,.tensorflow.serving.ModelVersionStatus.State\x12/\n\x06status\x18\x03 \x01(\x0b\x32\x1f.tensorflow.serving.StatusProto\"S\n\x05State\x12\x0b\n\x07UNKNOWN\x10\x00\x12\t\n\x05START\x10\n\x12\x0b\n\x07LOADING\x10\x14\x12\r\n\tAVAILABLE\x10\x1e\x12\r\n\tUNLOADING\x10(\x12\x07\n\x03\x45ND\x10\x32\"t\n\x16GetModelStatusResponse\x12Z\n\x14model_version_status\x18\x01 \x03(\x0b\x32&.tensorflow.serving.ModelVersionStatusR\x14model_version_status\"L\n\x13ReloadConfigRequest\x12\x35\n\x06\x63onfig\x18\x01 \x01(\x0b\x32%.tensorflow.serving.ModelServerConfig\"G\n\x14ReloadConfigResponse\x12/\n\x06status\x18\x01 \x01(\x0b\x32\x1f.tensorflow.serving.StatusProto\"\xba\x01\n\x11SessionRunRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12*\n\x04\x66\x65\x65\x64\x18\x02 \x03(\x0b\x32\x1c.tensorflow.NamedTensorProto\x12\r\n\x05\x66\x65tch\x18\x03 \x03(\t\x12\x0e\n\x06target\x18\x04 \x03(\t\x12\'\n\x07options\x18\x05 \x01(\x0b\x32\x16.tensorflow.RunOptions\"\xa0\x01\n\x12SessionRunResponse\x12\x31\n\nmodel_spec\x18\x03 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12,\n\x06tensor\x18\x01 \x03(\x0b\x32\x1c.tensorflow.NamedTensorProto\x12)\n\x08metadata\x18\x02 \x01(\x0b\x32\x17.tensorflow.RunMetadata\"\x97\x01\n\x0bLogMetadata\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12;\n\x0fsampling_config\x18\x02 \x01(\x0b\x32\".tensorflow.serving.SamplingConfig\x12\x18\n\x10saved_model_tags\x18\x03 \x03(\t\"\x87\x01\n\x0b\x43lassifyLog\x12:\n\x07request\x18\x01 \x01(\x0b\x32).tensorflow.serving.ClassificationRequest\x12<\n\x08response\x18\x02 \x01(\x0b\x32*.tensorflow.serving.ClassificationResponse\"~\n\nRegressLog\x12\x36\n\x07request\x18\x01 \x01(\x0b\x32%.tensorflow.serving.RegressionRequest\x12\x38\n\x08response\x18\x02 \x01(\x0b\x32&.tensorflow.serving.RegressionResponse\"x\n\nPredictLog\x12\x33\n\x07request\x18\x01 \x01(\x0b\x32\".tensorflow.serving.PredictRequest\x12\x35\n\x08response\x18\x02 \x01(\x0b\x32#.tensorflow.serving.PredictResponse\"\x8d\x01\n\x11MultiInferenceLog\x12:\n\x07request\x18\x01 \x01(\x0b\x32).tensorflow.serving.MultiInferenceRequest\x12<\n\x08response\x18\x02 \x01(\x0b\x32*.tensorflow.serving.MultiInferenceResponse\"\x81\x01\n\rSessionRunLog\x12\x36\n\x07request\x18\x01 \x01(\x0b\x32%.tensorflow.serving.SessionRunRequest\x12\x38\n\x08response\x18\x02 \x01(\x0b\x32&.tensorflow.serving.SessionRunResponse\"\xfd\x02\n\rPredictionLog\x12\x35\n\x0clog_metadata\x18\x01 \x01(\x0b\x32\x1f.tensorflow.serving.LogMetadata\x12\x37\n\x0c\x63lassify_log\x18\x02 \x01(\x0b\x32\x1f.tensorflow.serving.ClassifyLogH\x00\x12\x35\n\x0bregress_log\x18\x03 \x01(\x0b\x32\x1e.tensorflow.serving.RegressLogH\x00\x12\x35\n\x0bpredict_log\x18\x06 \x01(\x0b\x32\x1e.tensorflow.serving.PredictLogH\x00\x12\x44\n\x13multi_inference_log\x18\x04 \x01(\x0b\x32%.tensorflow.serving.MultiInferenceLogH\x00\x12<\n\x0fsession_run_log\x18\x05 \x01(\x0b\x32!.tensorflow.serving.SessionRunLogH\x00\x42\n\n\x08log_typeB\x03\xf8\x01\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'min_tfs_client_tpu.protos.tfs_apis_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\370\001\001'
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._options = None
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_options = b'8\001'
  _GETMODELMETADATARESPONSE_METADATAENTRY._options = None
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_options = b'8\001'
  _STATUSPROTO._serialized_start=381
  _STATUSPROTO._serialized_end=488
  _MODELSPEC._serialized_start=491
  _MODELSPEC._serialized_end=631
  _PREDICTREQUEST._serialized_start=634
  _PREDICTREQUEST._serialized_end=860
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=790
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=860
  _PREDICTRESPONSE._serialized_start=863
  _PREDICTRESPONSE._serialized_end=1071
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=1000
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=1071
  _EXAMPLELIST._serialized_start=1073
  _EXAMPLELIST._serialized_end=1125
  _EXAMPLELISTWITHCONTEXT._serialized_start=1127
  _EXAMPLELISTWITHCONTEXT._serialized_end=1228
  _INPUT._serialized_start=1231
  _INPUT._serialized_end=1384
  _CLASS._serialized_start=1386
  _CLASS._serialized_end=1423
  _CLASSIFICATIONS._serialized_start=1425
  _CLASSIFICATIONS._serialized_end=1486
  _CLASSIFICATIONRESULT._serialized_start=1488
  _CLASSIFICATIONRESULT._serialized_end=1572
  _CLASSIFICATIONREQUEST._serialized_start=1574
  _CLASSIFICATIONREQUEST._serialized_end=1690
  _CLASSIFICATIONRESPONSE._serialized_start=1693
  _CLASSIFICATIONRESPONSE._serialized_end=1826
  _REGRESSION._serialized_start=1828
  _REGRESSION._serialized_end=1855
  _REGRESSIONRESULT._serialized_start=1857
  _REGRESSIONRESULT._serialized_end=1928
  _REGRESSIONREQUEST._serialized_start=1930
  _REGRESSIONREQUEST._serialized_end=2042
  _REGRESSIONRESPONSE._serialized_start=2044
  _REGRESSIONRESPONSE._serialized_end=2169
  _INFERENCETASK._serialized_start=2171
  _INFERENCETASK._serialized_end=2258
  _INFERENCERESULT._serialized_start=2261
  _INFERENCERESULT._serialized_end=2481
  _MULTIINFERENCEREQUEST._serialized_start=2483
  _MULTIINFERENCEREQUEST._serialized_end=2598
  _MULTIINFERENCERESPONSE._serialized_start=2600
  _MULTIINFERENCERESPONSE._serialized_end=2678
  _SIGNATUREDEFMAP._serialized_start=2681
  _SIGNATUREDEFMAP._serialized_end=2855
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_start=2778
  _SIGNATUREDEFMAP_SIGNATUREDEFENTRY._serialized_end=2855
  _GETMODELMETADATAREQUEST._serialized_start=2857
  _GETMODELMETADATAREQUEST._serialized_end=2957
  _GETMODELMETADATARESPONSE._serialized_start=2960
  _GETMODELMETADATARESPONSE._serialized_end=3186
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_start=3117
  _GETMODELMETADATARESPONSE_METADATAENTRY._serialized_end=3186
  _GETMODELSTATUSREQUEST._serialized_start=3188
  _GETMODELSTATUSREQUEST._serialized_end=3262
  _MODELVERSIONSTATUS._serialized_start=3265
  _MODELVERSIONSTATUS._serialized_end=3497
  _MODELVERSIONSTATUS_STATE._serialized_start=3414
  _MODELVERSIONSTATUS_STATE._serialized_end=3497
  _GETMODELSTATUSRESPONSE._serialized_start=3499
  _GETMODELSTATUSRESPONSE._serialized_end=3615
  _RELOADCONFIGREQUEST._serialized_start=3617
  _RELOADCONFIGREQUEST._serialized_end=3693
  _RELOADCONFIGRESPONSE._serialized_start=3695
  _RELOADCONFIGRESPONSE._serialized_end=3766
  _SESSIONRUNREQUEST._serialized_start=3769
  _SESSIONRUNREQUEST._serialized_end=3955
  _SESSIONRUNRESPONSE._serialized_start=3958
  _SESSIONRUNRESPONSE._serialized_end=4118
  _LOGMETADATA._serialized_start=4121
  _LOGMETADATA._serialized_end=4272
  _CLASSIFYLOG._serialized_start=4275
  _CLASSIFYLOG._serialized_end=4410
  _REGRESSLOG._serialized_start=4412
  _REGRESSLOG._serialized_end=4538
  _PREDICTLOG._serialized_start=4540
  _PREDICTLOG._serialized_end=4660
  _MULTIINFERENCELOG._serialized_start=4663
  _MULTIINFERENCELOG._serialized_end=4804
  _SESSIONRUNLOG._serialized_start=4807
  _SESSIONRUNLOG._serialized_end=4936
  _PREDICTIONLOG._serialized_start=4939
  _PREDICTIONLOG._serialized_end=5320
# @@protoc_insertion_point(module_scope)
