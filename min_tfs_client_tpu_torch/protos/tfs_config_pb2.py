# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: min_tfs_client_tpu/protos/tfs_config.proto
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
from min_tfs_client_tpu_torch.protos import tf_config_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__config__pb2
from min_tfs_client_tpu_torch.protos import tf_tensor_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__tensor__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n*min_tfs_client_tpu/protos/tfs_config.proto\x12\x12tensorflow.serving\x1a\x19google/protobuf/any.proto\x1a\x1egoogle/protobuf/wrappers.proto\x1a)min_tfs_client_tpu/protos/tf_config.proto\x1a)min_tfs_client_tpu/protos/tf_tensor.proto\"\x84\x07\n!FileSystemStoragePathSourceConfig\x12Z\n\tservables\x18\x05 \x03(\x0b\x32G.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableToMonitor\x12\x19\n\rservable_name\x18\x01 \x01(\tB\x02\x18\x01\x12\x15\n\tbase_path\x18\x02 \x01(\tB\x02\x18\x01\x12%\n\x1d\x66ile_system_poll_wait_seconds\x18\x03 \x01(\x03\x12,\n fail_if_zero_versions_at_startup\x18\x04 \x01(\x08\x42\x02\x18\x01\x12(\n servable_versions_always_present\x18\x06 \x01(\x08\x1a\x9d\x03\n\x15ServableVersionPolicy\x12\x64\n\x06latest\x18\x64 \x01(\x0b\x32R.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableVersionPolicy.LatestH\x00\x12^\n\x03\x61ll\x18\x65 \x01(\x0b\x32O.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableVersionPolicy.AllH\x00\x12h\n\x08specific\x18\x66 \x01(\x0b\x32T.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableVersionPolicy.SpecificH\x00\x1a\x1e\n\x06Latest\x12\x14\n\x0cnum_versions\x18\x01 \x01(\r\x1a\x05\n\x03\x41ll\x1a\x1c\n\x08Specific\x12\x10\n\x08versions\x18\x01 \x03(\x03\x42\x0f\n\rpolicy_choice\x1a\xb1\x01\n\x11ServableToMonitor\x12\x15\n\rservable_name\x18\x01 \x01(\t\x12\x11\n\tbase_path\x18\x02 \x01(\t\x12l\n\x17servable_version_policy\x18\x04 \x01(\x0b\x32K.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableVersionPolicyJ\x04\x08\x03\x10\x04\";\n\x12LogCollectorConfig\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x17\n\x0f\x66ilename_prefix\x18\x02 \x01(\t\"\'\n\x0eSamplingConfig\x12\x15\n\rsampling_rate\x18\x01 \x01(\x01\"\x92\x01\n\rLoggingConfig\x12\x44\n\x14log_collector_config\x18\x01 \x01(\x0b\x32&.tensorflow.serving.LogCollectorConfig\x12;\n\x0fsampling_config\x18\x02 \x01(\x0b\x32\".tensorflow.serving.SamplingConfig\"\xab\x03\n\x0bModelConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tbase_path\x18\x02 \x01(\t\x12\x35\n\nmodel_type\x18\x03 \x01(\x0e\x32\x1d.tensorflow.serving.ModelTypeB\x02\x18\x01\x12\x16\n\x0emodel_platform\x18\x04 \x01(\t\x12i\n\x14model_version_policy\x18\x07 \x01(\x0b\x32K.tensorflow.serving.FileSystemStoragePathSourceConfig.ServableVersionPolicy\x12J\n\x0eversion_labels\x18\x08 \x03(\x0b\x32\x32.tensorflow.serving.ModelConfig.VersionLabelsEntry\x12\x39\n\x0elogging_config\x18\x06 \x01(\x0b\x32!.tensorflow.serving.LoggingConfig\x1a\x34\n\x12VersionLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01J\x04\x08\x05\x10\x06\"B\n\x0fModelConfigList\x12/\n\x06\x63onfig\x18\x01 \x03(\x0b\x32\x1f.tensorflow.serving.ModelConfig\"\x94\x01\n\x11ModelServerConfig\x12@\n\x11model_config_list\x18\x01 \x01(\x0b\x32#.tensorflow.serving.ModelConfigListH\x00\x12\x33\n\x13\x63ustom_model_config\x18\x02 \x01(\x0b\x32\x14.google.protobuf.AnyH\x00\x42\x08\n\x06\x63onfig\"0\n\x10PrometheusConfig\x12\x0e\n\x06\x65nable\x18\x01 \x01(\x08\x12\x0c\n\x04path\x18\x02 \x01(\t\"S\n\x10MonitoringConfig\x12?\n\x11prometheus_config\x18\x01 \x01(\x0b\x32$.tensorflow.serving.PrometheusConfig\"E\n\x0ePlatformConfig\x12\x33\n\x15source_adapter_config\x18\x01 \x01(\x0b\x32\x14.google.protobuf.Any\"\xc5\x01\n\x11PlatformConfigMap\x12T\n\x10platform_configs\x18\x01 \x03(\x0b\x32:.tensorflow.serving.PlatformConfigMap.PlatformConfigsEntry\x1aZ\n\x14PlatformConfigsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x31\n\x05value\x18\x02 \x01(\x0b\x32\".tensorflow.serving.PlatformConfig:\x02\x38\x01\"^\n\tSSLConfig\x12\x12\n\nserver_key\x18\x01 \x01(\t\x12\x13\n\x0bserver_cert\x18\x02 \x01(\t\x12\x11\n\tcustom_ca\x18\x03 \x01(\t\x12\x15\n\rclient_verify\x18\x04 \x01(\x08\"Q\n\x12ModelWarmupOptions\x12;\n\x16num_request_iterations\x18\x01 \x01(\x0b\x32\x1b.google.protobuf.Int32Value\"\xdb\x04\n\x13SessionBundleConfig\x12\x16\n\x0esession_target\x18\x01 \x01(\t\x12/\n\x0esession_config\x18\x02 \x01(\x0b\x32\x17.tensorflow.ConfigProto\x12\x43\n\x13\x62\x61tching_parameters\x18\x03 \x01(\x0b\x32&.tensorflow.serving.BatchingParameters\x12\x46\n!session_run_load_threadpool_index\x18\x04 \x01(\x0b\x32\x1b.google.protobuf.Int32Value\x12\x34\n,experimental_transient_ram_bytes_during_load\x18\x05 \x01(\x04\x12\x18\n\x10saved_model_tags\x18\x06 \x03(\t\x12G\n experimental_fixed_input_tensors\x18\x8a\x06 \x03(\x0b\x32\x1c.tensorflow.NamedTensorProto\x12\x1c\n\x13\x65nable_model_warmup\x18\x8b\x06 \x01(\x08\x12\x45\n\x14model_warmup_options\x18\x8c\x06 \x01(\x0b\x32&.tensorflow.serving.ModelWarmupOptions\x12 \n\x17\x65nable_session_metadata\x18\x8d\x06 \x01(\x08\x12\x33\n*remove_unused_fields_from_bundle_metagraph\x18\x8e\x06 \x01(\x08\x12\x19\n\x10use_tflite_model\x18\x8f\x06 \x01(\x08\"\xf0\x02\n\x12\x42\x61tchingParameters\x12\x33\n\x0emax_batch_size\x18\x01 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\x12\x39\n\x14\x62\x61tch_timeout_micros\x18\x02 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\x12\x39\n\x14max_enqueued_batches\x18\x03 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\x12\x36\n\x11num_batch_threads\x18\x04 \x01(\x0b\x32\x1b.google.protobuf.Int64Value\x12\x36\n\x10thread_pool_name\x18\x05 \x01(\x0b\x32\x1c.google.protobuf.StringValue\x12\x1b\n\x13\x61llowed_batch_sizes\x18\x06 \x03(\x03\x12\"\n\x1apad_variable_length_inputs\x18\x07 \x01(\x08*N\n\tModelType\x12\x1e\n\x16MODEL_TYPE_UNSPECIFIED\x10\x00\x1a\x02\x08\x01\x12\x12\n\nTENSORFLOW\x10\x01\x1a\x02\x08\x01\x12\r\n\x05OTHER\x10\x02\x1a\x02\x08\x01\x42\x03\xf8\x01\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'min_tfs_client_tpu.protos.tfs_config_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\370\001\001'
  _MODELTYPE.values_by_name["MODEL_TYPE_UNSPECIFIED"]._options = None
  _MODELTYPE.values_by_name["MODEL_TYPE_UNSPECIFIED"]._serialized_options = b'\010\001'
  _MODELTYPE.values_by_name["TENSORFLOW"]._options = None
  _MODELTYPE.values_by_name["TENSORFLOW"]._serialized_options = b'\010\001'
  _MODELTYPE.values_by_name["OTHER"]._options = None
  _MODELTYPE.values_by_name["OTHER"]._serialized_options = b'\010\001'
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['servable_name']._options = None
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['servable_name']._serialized_options = b'\030\001'
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['base_path']._options = None
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['base_path']._serialized_options = b'\030\001'
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['fail_if_zero_versions_at_startup']._options = None
  _FILESYSTEMSTORAGEPATHSOURCECONFIG.fields_by_name['fail_if_zero_versions_at_startup']._serialized_options = b'\030\001'
  _MODELCONFIG_VERSIONLABELSENTRY._options = None
  _MODELCONFIG_VERSIONLABELSENTRY._serialized_options = b'8\001'
  _MODELCONFIG.fields_by_name['model_type']._options = None
  _MODELCONFIG.fields_by_name['model_type']._serialized_options = b'\030\001'
  _PLATFORMCONFIGMAP_PLATFORMCONFIGSENTRY._options = None
  _PLATFORMCONFIGMAP_PLATFORMCONFIGSENTRY._serialized_options = b'8\001'
  _MODELTYPE._serialized_start=3576
  _MODELTYPE._serialized_end=3654
  _FILESYSTEMSTORAGEPATHSOURCECONFIG._serialized_start=212
  _FILESYSTEMSTORAGEPATHSOURCECONFIG._serialized_end=1112
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY._serialized_start=519
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY._serialized_end=932
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_LATEST._serialized_start=848
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_LATEST._serialized_end=878
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_ALL._serialized_start=880
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_ALL._serialized_end=885
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_SPECIFIC._serialized_start=887
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLEVERSIONPOLICY_SPECIFIC._serialized_end=915
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLETOMONITOR._serialized_start=935
  _FILESYSTEMSTORAGEPATHSOURCECONFIG_SERVABLETOMONITOR._serialized_end=1112
  _LOGCOLLECTORCONFIG._serialized_start=1114
  _LOGCOLLECTORCONFIG._serialized_end=1173
  _SAMPLINGCONFIG._serialized_start=1175
  _SAMPLINGCONFIG._serialized_end=1214
  _LOGGINGCONFIG._serialized_start=1217
  _LOGGINGCONFIG._serialized_end=1363
  _MODELCONFIG._serialized_start=1366
  _MODELCONFIG._serialized_end=1793
  _MODELCONFIG_VERSIONLABELSENTRY._serialized_start=1735
  _MODELCONFIG_VERSIONLABELSENTRY._serialized_end=1787
  _MODELCONFIGLIST._serialized_start=1795
  _MODELCONFIGLIST._serialized_end=1861
  _MODELSERVERCONFIG._serialized_start=1864
  _MODELSERVERCONFIG._serialized_end=2012
  _PROMETHEUSCONFIG._serialized_start=2014
  _PROMETHEUSCONFIG._serialized_end=2062
  _MONITORINGCONFIG._serialized_start=2064
  _MONITORINGCONFIG._serialized_end=2147
  _PLATFORMCONFIG._serialized_start=2149
  _PLATFORMCONFIG._serialized_end=2218
  _PLATFORMCONFIGMAP._serialized_start=2221
  _PLATFORMCONFIGMAP._serialized_end=2418
  _PLATFORMCONFIGMAP_PLATFORMCONFIGSENTRY._serialized_start=2328
  _PLATFORMCONFIGMAP_PLATFORMCONFIGSENTRY._serialized_end=2418
  _SSLCONFIG._serialized_start=2420
  _SSLCONFIG._serialized_end=2514
  _MODELWARMUPOPTIONS._serialized_start=2516
  _MODELWARMUPOPTIONS._serialized_end=2597
  _SESSIONBUNDLECONFIG._serialized_start=2600
  _SESSIONBUNDLECONFIG._serialized_end=3203
  _BATCHINGPARAMETERS._serialized_start=3206
  _BATCHINGPARAMETERS._serialized_end=3574
# @@protoc_insertion_point(module_scope)
