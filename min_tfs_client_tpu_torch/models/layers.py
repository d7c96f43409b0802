"""Shared building blocks for the served model families (BERT here).

Counterpart of `min_tfs_client_tpu/models/layers.py`, as plain functions
over nested dicts of tensors so a JAX-exported `params.npz` maps one to
one. Numerics copy the JAX package's: matmuls take bf16 operands (with f32
accumulation inside the BLAS) and produce bf16, normalisation runs in f32
and casts back, the MLP's gelu is the tanh approximation, and attention
dispatches to the Hopper flash kernel on a CUDA tensor (ops/attention.py).

Dense kernels stay (d_in, d_out) and apply as x @ W; `export.params_from_jax`
stores them in bf16 once, so the per-call casts below are no-ops.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from min_tfs_client_tpu_torch.ops.attention import attention

COMPUTE_DTYPE = torch.bfloat16


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x.to(COMPUTE_DTYPE) @ params["kernel"].to(COMPUTE_DTYPE)
    if "bias" in params:
        y = y + params["bias"].to(COMPUTE_DTYPE)
    return y


def layer_norm(params: dict, x: torch.Tensor, *,
               eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """embedding[ids] with JAX's index rule: negative ids wrap once, then
    out-of-range ids clamp to the table. Torch would raise on the CPU and
    hit a device-side assert on CUDA, which poisons the process's context."""
    table = params["embedding"].to(COMPUTE_DTYPE)
    vocab = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
    return table[ids]


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> a (B, H, S, D) view; the head dim stays contiguous,
    which is all the flash kernel asks of its strides."""
    b, s, d = x.shape
    return x.view(b, s, num_heads, d // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def mha(params: dict, x: torch.Tensor, *, num_heads: int,
        lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention over x with per-example key lengths.
    Cross-attention, causal masks, additive bias and the KV-cache modes
    (prefill, decode, verify block) come with the T5 slice. Returns the
    output projection, (B, S, d_model)."""
    q = _heads(dense(params["query"], x), num_heads)
    k = _heads(dense(params["key"], x), num_heads)
    v = _heads(dense(params["value"], x), num_heads)
    out = attention(q, k, v, lengths=lengths)
    return dense(params["out"], _unheads(out))


# jax.nn.gelu's default is the tanh approximation; F.gelu's is exact.
gelu_tanh = functools.partial(F.gelu, approximate="tanh")


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """wo(gelu(wi(x))); the gated variant comes with the T5 slice."""
    return dense(params["wo"], gelu_tanh(dense(params["wi"], x)))


def lengths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 0/1 attention mask -> (B,) int32 valid lengths. Serving
    batches are right-padded, so a row sum is exact."""
    return mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
