"""Copies of the JAX package's TensorFlow / TF-Serving protos.

Imported lazily by the modules that need them, so the rest of the port
loads without protobuf installed.
"""
