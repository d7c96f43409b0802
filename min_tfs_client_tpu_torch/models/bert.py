"""BERT encoder family: the port's main-path model.

Counterpart of `min_tfs_client_tpu/models/bert.py`: the same config, the
same post-LN encoder and pooler/head numerics, and the same four serving
signatures (serving_default/predict, classify, regress) with the same
specs, method names and class labels, so GetModelMetadata matches.

Not in this slice, each raising NotImplementedError: Switch-MoE layers,
pipeline-parallel serving and the long-context (ring attention) encoder
come with the `parallel/` slice; sequence-length bucketing comes with the
Signature's later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from min_tfs_client_tpu_torch.models import layers as nn
from min_tfs_client_tpu_torch.utils.device import resolve_device

PARALLEL_SLICE = ("comes with the port's parallel/ slice (ROADMAP Queue 1, "
                   "item 14)")


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    layer_norm_eps: float = 1e-12
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """Test-scale config: same code paths, toy dimensions."""
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("intermediate_size", 64)
        kw.setdefault("max_position", 64)
        return BertConfig(**kw)


# -- parameters ----------------------------------------------------------------


def init_params(rng: np.random.Generator, config: BertConfig) -> dict:
    """Random parameters as float32 numpy arrays, in the JAX package's tree
    layout and with its init_params' stddevs (dense N(0, 1/d_in), biases 0,
    embeddings N(0, 0.02), LayerNorm 1/0). The draws differ from JAX's."""
    if config.moe_experts:
        raise NotImplementedError(f"BERT Switch-MoE {PARALLEL_SLICE}")

    def dense(d_in, d_out):
        return {"kernel": (rng.standard_normal((d_in, d_out), np.float32)
                           / np.float32(np.sqrt(d_in))),
                "bias": np.zeros((d_out,), np.float32)}

    def embed(vocab, dim):
        return {"embedding": rng.standard_normal((vocab, dim), np.float32)
                * np.float32(0.02)}

    def norm(dim):
        return {"scale": np.ones((dim,), np.float32),
                "bias": np.zeros((dim,), np.float32)}

    h, ff = config.hidden_size, config.intermediate_size
    params = {
        "embeddings": {
            "word": embed(config.vocab_size, h),
            "position": embed(config.max_position, h),
            "token_type": embed(config.type_vocab_size, h),
            "norm": norm(h),
        },
        "layers": [],
        "pooler": dense(h, h),
        "head": dense(h, config.num_labels),
    }
    for _ in range(config.num_layers):
        params["layers"].append({
            "attention": {name: dense(h, h)
                          for name in ("query", "key", "value", "out")},
            "attention_norm": norm(h),
            "mlp_norm": norm(h),
            "mlp": {"wi": dense(h, ff), "wo": dense(ff, h)},
        })
    return params


# -- the encoder ---------------------------------------------------------------


def encode(params: dict, config: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S) ids -> (B, S, H) contextual embeddings. Post-LN transformer."""
    _, s = input_ids.shape
    emb = params["embeddings"]
    x = nn.embed(emb["word"], input_ids)
    x = x + nn.embed(emb["position"],
                     torch.arange(s, device=input_ids.device)[None, :])
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + nn.embed(emb["token_type"], token_type_ids)
    x = nn.layer_norm(emb["norm"], x, eps=config.layer_norm_eps)

    lengths = nn.lengths_from_mask(attention_mask)
    for layer in params["layers"]:
        attn = nn.mha(layer["attention"], x, num_heads=config.num_heads,
                      lengths=lengths)
        x = nn.layer_norm(layer["attention_norm"], x + attn,
                          eps=config.layer_norm_eps)
        x = nn.layer_norm(layer["mlp_norm"], x + nn.mlp(layer["mlp"], x),
                          eps=config.layer_norm_eps)
    return x


def pooled(params: dict, config: BertConfig, input_ids, attention_mask,
           token_type_ids=None) -> torch.Tensor:
    """[CLS] vector through the tanh pooler -> (B, H) f32."""
    x = encode(params, config, input_ids, attention_mask, token_type_ids)
    return torch.tanh(nn.dense(params["pooler"], x[:, 0])).float()


def logits_fn(params: dict, config: BertConfig, input_ids, attention_mask,
              token_type_ids=None) -> torch.Tensor:
    h = pooled(params, config, input_ids, attention_mask, token_type_ids)
    return nn.dense(params["head"], h.to(nn.COMPUTE_DTYPE)).float()


# -- servable construction -----------------------------------------------------


def build_signatures(params: dict, config: BertConfig, *, seq_len: int,
                     device=None,
                     class_labels: list[bytes] | None = None,
                     seq_buckets: tuple | list | None = None,
                     long_context_seq: int | None = None,
                     pipeline_mesh=None,
                     pipeline_n_micro: int | None = None) -> dict:
    """The model family's serving surface (the JAX package's signatures):

      serving_default / predict: ids+mask -> logits, probabilities
      classify: Example path -> scores (+classes when labels given)
      regress:  Example path -> outputs (label-0 logit as the value)

    `params` is the port's tree (export.params_from_jax) on `device`
    (None: the CUDA card)."""
    from min_tfs_client_tpu_torch.servables.servable import (
        CLASSIFY_METHOD_NAME,
        CLASSIFY_OUTPUT_SCORES,
        REGRESS_METHOD_NAME,
        REGRESS_OUTPUTS,
        Signature,
        TensorSpec,
    )

    device = resolve_device(device)

    if pipeline_mesh is not None or pipeline_n_micro is not None:
        raise NotImplementedError(
            f"pipeline-parallel BERT serving {PARALLEL_SLICE}")
    if long_context_seq:
        raise NotImplementedError(
            f"the long-context BERT encoder (ring attention) {PARALLEL_SLICE}")
    if seq_buckets:
        raise NotImplementedError(
            "sequence-length bucketing comes with the port's Signature "
            "slice (ROADMAP Queue 1, item 3)")

    def compute_logits(params, ids, mask):
        return logits_fn(params, config, ids, mask)

    def predict(params, inputs):
        logits = compute_logits(params, inputs["input_ids"],
                                inputs["attention_mask"])
        return {"logits": logits,
                "probabilities": torch.softmax(logits, dim=-1)}

    predict_sig = Signature(
        fn=predict,
        params=params,
        device=device,
        inputs={"input_ids": TensorSpec(np.int32, (None, seq_len)),
                "attention_mask": TensorSpec(np.int32, (None, seq_len))},
        outputs={"logits": TensorSpec(np.float32, (None, config.num_labels)),
                 "probabilities": TensorSpec(np.float32,
                                             (None, config.num_labels))},
    )

    def classify(params, inputs):
        logits = compute_logits(params, inputs["input_ids"].int(),
                                inputs["attention_mask"].int())
        return {CLASSIFY_OUTPUT_SCORES: torch.softmax(logits, dim=-1)}

    classify_sig = Signature(
        fn=classify,
        params=params,
        device=device,
        inputs={"input_ids": TensorSpec(np.int64, (None, seq_len)),
                "attention_mask": TensorSpec(np.int64, (None, seq_len))},
        outputs={CLASSIFY_OUTPUT_SCORES: TensorSpec(
            np.float32, (None, config.num_labels))},
        method_name=CLASSIFY_METHOD_NAME,
        class_labels=class_labels,
    )

    def regress(params, inputs):
        logits = compute_logits(params, inputs["input_ids"].int(),
                                inputs["attention_mask"].int())
        return {REGRESS_OUTPUTS: logits[:, 0]}

    regress_sig = Signature(
        fn=regress,
        params=params,
        device=device,
        inputs={"input_ids": TensorSpec(np.int64, (None, seq_len)),
                "attention_mask": TensorSpec(np.int64, (None, seq_len))},
        outputs={REGRESS_OUTPUTS: TensorSpec(np.float32, (None,))},
        method_name=REGRESS_METHOD_NAME,
    )

    return {"serving_default": predict_sig, "predict": predict_sig,
            "classify": classify_sig, "regress": regress_sig}
