"""PyTorch/CUDA port of min_tfs_client_tpu, for one NVIDIA H100.

Mirrors the JAX package's module paths; imports torch, numpy and (lazily)
google.protobuf, and nothing of JAX or of the JAX package. Slice 1 serves
BERT Predict in-process (server/local.py) on the hand-written Hopper
flash-attention kernel (csrc/flash_attention.cu).
"""
