# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: min_tfs_client_tpu/protos/tf_config.proto
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


from min_tfs_client_tpu_torch.protos import tf_graph_pb2 as min__tfs__client__tpu_dot_protos_dot_tf__graph__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)min_tfs_client_tpu/protos/tf_config.proto\x12\ntensorflow\x1a(min_tfs_client_tpu/protos/tf_graph.proto\"A\n\x15ThreadPoolOptionProto\x12\x13\n\x0bnum_threads\x18\x01 \x01(\x05\x12\x13\n\x0bglobal_name\x18\x02 \x01(\t\"\x89\x02\n\nGPUOptions\x12\'\n\x1fper_process_gpu_memory_fraction\x18\x01 \x01(\x01\x12\x14\n\x0c\x61llow_growth\x18\x04 \x01(\x08\x12\x16\n\x0e\x61llocator_type\x18\x02 \x01(\t\x12\x1f\n\x17\x64\x65\x66\x65rred_deletion_bytes\x18\x03 \x01(\x03\x12\x1b\n\x13visible_device_list\x18\x05 \x01(\t\x12\"\n\x1apolling_active_delay_usecs\x18\x06 \x01(\x05\x12$\n\x1cpolling_inactive_delay_msecs\x18\x07 \x01(\x05\x12\x1c\n\x14\x66orce_gpu_compatible\x18\x08 \x01(\x08\"\x92\x04\n\x0b\x43onfigProto\x12>\n\x0c\x64\x65vice_count\x18\x01 \x03(\x0b\x32(.tensorflow.ConfigProto.DeviceCountEntry\x12$\n\x1cintra_op_parallelism_threads\x18\x02 \x01(\x05\x12$\n\x1cinter_op_parallelism_threads\x18\x05 \x01(\x05\x12\x1f\n\x17use_per_session_threads\x18\t \x01(\x08\x12G\n\x1csession_inter_op_thread_pool\x18\x0c \x03(\x0b\x32!.tensorflow.ThreadPoolOptionProto\x12\x18\n\x10placement_period\x18\x03 \x01(\x05\x12\x16\n\x0e\x64\x65vice_filters\x18\x04 \x03(\t\x12+\n\x0bgpu_options\x18\x06 \x01(\x0b\x32\x16.tensorflow.GPUOptions\x12\x1c\n\x14\x61llow_soft_placement\x18\x07 \x01(\x08\x12\x1c\n\x14log_device_placement\x18\x08 \x01(\x08\x12\x1f\n\x17operation_timeout_in_ms\x18\x0b \x01(\x03\x12\x1d\n\x15isolate_session_state\x18\x0f \x01(\x08\x1a\x32\n\x10\x44\x65viceCountEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\"\xa7\x03\n\nRunOptions\x12\x36\n\x0btrace_level\x18\x01 \x01(\x0e\x32!.tensorflow.RunOptions.TraceLevel\x12\x15\n\rtimeout_in_ms\x18\x02 \x01(\x03\x12\x1c\n\x14inter_op_thread_pool\x18\x03 \x01(\x05\x12\x1f\n\x17output_partition_graphs\x18\x05 \x01(\x08\x12*\n\"report_tensor_allocations_upon_oom\x18\x07 \x01(\x08\x12\x39\n\x0c\x65xperimental\x18\x08 \x01(\x0b\x32#.tensorflow.RunOptions.Experimental\x1aJ\n\x0c\x45xperimental\x12\x1c\n\x14\x63ollective_graph_key\x18\x01 \x01(\x03\x12\x1c\n\x14use_run_handler_pool\x18\x02 \x01(\x08\"R\n\nTraceLevel\x12\x0c\n\x08NO_TRACE\x10\x00\x12\x12\n\x0eSOFTWARE_TRACE\x10\x01\x12\x12\n\x0eHARDWARE_TRACE\x10\x02\x12\x0e\n\nFULL_TRACE\x10\x03J\x04\x08\x04\x10\x05\"=\n\x0bRunMetadata\x12.\n\x10partition_graphs\x18\x03 \x03(\x0b\x32\x14.tensorflow.GraphDefB\x03\xf8\x01\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'min_tfs_client_tpu.protos.tf_config_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\370\001\001'
  _CONFIGPROTO_DEVICECOUNTENTRY._options = None
  _CONFIGPROTO_DEVICECOUNTENTRY._serialized_options = b'8\001'
  _THREADPOOLOPTIONPROTO._serialized_start=99
  _THREADPOOLOPTIONPROTO._serialized_end=164
  _GPUOPTIONS._serialized_start=167
  _GPUOPTIONS._serialized_end=432
  _CONFIGPROTO._serialized_start=435
  _CONFIGPROTO._serialized_end=965
  _CONFIGPROTO_DEVICECOUNTENTRY._serialized_start=915
  _CONFIGPROTO_DEVICECOUNTENTRY._serialized_end=965
  _RUNOPTIONS._serialized_start=968
  _RUNOPTIONS._serialized_end=1391
  _RUNOPTIONS_EXPERIMENTAL._serialized_start=1227
  _RUNOPTIONS_EXPERIMENTAL._serialized_end=1301
  _RUNOPTIONS_TRACELEVEL._serialized_start=1303
  _RUNOPTIONS_TRACELEVEL._serialized_end=1385
  _RUNMETADATA._serialized_start=1393
  _RUNMETADATA._serialized_end=1454
# @@protoc_insertion_point(module_scope)
