"""Tensor dtypes and the TensorProto codec."""
