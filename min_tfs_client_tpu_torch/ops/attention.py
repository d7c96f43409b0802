"""Attention ops: the hand-written Hopper flash-attention kernel and its
plain PyTorch version.

Counterpart of `min_tfs_client_tpu/ops/attention.py` (dense half):

 * `flash_attention` — wrapper of the CUDA kernel in
   `csrc/flash_attention.cu`, which replaces the Pallas TPU kernel of the
   same name. On a CUDA tensor it launches the kernel or raises; on a CPU
   tensor it runs `attention_reference`.
 * `attention_reference` — the plain version: the same semantics written
   with ordinary tensor ops. The CPU path, and what the kernel is held
   against on the card.
 * `attention` — the dispatcher every model calls, with the JAX package's
   gate.

The paged kernel (`paged_flash_attention`) comes with the T5 slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from min_tfs_client_tpu_torch.ops import _kernels

NEG_INF = -1e30  # finite -inf stand-in: keeps masked softmax NaN-free

# Head dims the kernel takes (multiples of 8 up to this), and its dtypes.
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Plain softmax(q k^T / sqrt(d) + bias) v.

    Shapes: q (B, H, Sq, D); k, v (B, H, Skv, D); lengths (B,) valid key
    counts; bias broadcastable to (B, H, Sq, Skv). Returns (B, H, Sq, D)
    in q.dtype; softmax runs in f32. `causal_offset` is query row 0's
    absolute key position (default Skv-Sq: right-aligned)."""
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        offset = skv - sq if causal_offset is None else causal_offset
        qi = torch.arange(sq, device=q.device)[:, None] + offset
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    if lengths is not None:
        ki = torch.arange(skv, device=q.device)[None, None, None, :]
        s = torch.where(ki < lengths.to(q.device)[:, None, None, None], s,
                        NEG_INF)
    p = torch.softmax(s, dim=-1)
    if lengths is not None:
        # Fully-masked rows -> zeros (not a uniform mean over masked V),
        # matching the kernel.
        all_masked = s.amax(dim=-1, keepdim=True) <= NEG_INF * 0.5
        p = torch.where(all_masked, 0.0, p)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """The Hopper kernel. Same contract as attention_reference minus bias,
    except that lengths are clamped to Skv (see the kernel's note).

    Takes q (B, H, Sq, D), k/v (B, H, Skv, D) of one dtype (float32,
    float16 or bfloat16) with any strides whose head dim is contiguous;
    lengths (B,) int32 on the same device. The output is a (B, H, Sq, D)
    view of a (B, Sq, H, D) buffer, the layout the out projection reads.
    Raises on anything else. `flash_attention.launches` counts launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, lengths=lengths,
                                   scale=scale, causal_offset=causal_offset)
    _check_inputs(q, k, v, lengths)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / float(np.sqrt(d))
    q_offset = 0
    if causal:
        q_offset = skv - sq if causal_offset is None else int(causal_offset)
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    fn = _kernels.entry("flash_attention")
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(),
             None if lengths is None else lengths.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], b, h, sq, skv, d, float(scale),
             int(bool(causal)), q_offset,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_inputs(q, k, v, lengths) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q is on {q.device}, "
                         "expected a CUDA or CPU tensor")
    if q.get_device() != torch.cuda.current_device():
        # The kernel launches on the current device's current stream.
        raise ValueError(f"flash_attention: q is on {q.device}, the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q is {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            "flash_attention: expected q (B,H,Sq,D) and k, v (B,H,Skv,D); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                f"flash_attention: {name}'s head dim is not contiguous "
                f"(strides {t.stride()})")
    if lengths is not None:
        if (lengths.device != q.device or lengths.dtype != torch.int32
                or lengths.shape != (b,) or not lengths.is_contiguous()):
            raise ValueError(
                "flash_attention: lengths must be a contiguous (B,) int32 "
                f"tensor on {q.device}; got {tuple(lengths.shape)} "
                f"{lengths.dtype} on {lengths.device}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Dispatch, with the JAX package's gate (attention.py:612-622) and
    nothing more: the kernel on a CUDA tensor with no additive bias, a head
    dim that is a multiple of 8, at least 8 query rows and a static offset;
    the plain version otherwise and on the CPU. A CUDA input that passes
    the gate but not the kernel's own checks (head dim, dtype) raises in
    flash_attention. Semantics identical."""
    use_kernel = (
        q.is_cuda
        and bias is None
        and q.shape[-1] % 8 == 0
        and q.shape[-2] >= 8
        and isinstance(causal_offset, (int, type(None)))
    )
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, lengths=lengths,
                               scale=scale, causal_offset=causal_offset)
    return attention_reference(q, k, v, causal=causal, lengths=lengths,
                               bias=bias, scale=scale,
                               causal_offset=causal_offset)
