"""The port's hand-written CUDA kernels on the card: each held against its
plain PyTorch version on every case chip_smoke.py checks, plus the served
BERT path's launch count. Marked `cuda`; each test skips without a card.
On the card: python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke

CASES = {case[0]: case for case in chip_smoke.kernel_cases()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(CASES))
def test_flash_attention_kernel_matches_plain(card, label):
    from min_tfs_client_tpu_torch.ops.attention import (
        attention_reference,
        flash_attention,
    )

    _, shape, skv, dtype, lengths, causal, offset, head_split = CASES[label]
    q, k, v, lens = chip_smoke._attention_inputs(shape, skv, dtype, lengths,
                                                 seed=3, head_split=head_split)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, lengths=lens,
                          causal_offset=offset)
    want = attention_reference(q, k, v, causal=causal, lengths=lens,
                               causal_offset=offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    atol, rtol = chip_smoke.KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_tiny_bert_served_on_the_card_launches_per_layer(card, tmp_path):
    from min_tfs_client_tpu_torch.models import bert, export
    from min_tfs_client_tpu_torch.ops.attention import flash_attention
    from min_tfs_client_tpu_torch.server import local

    config = bert.BertConfig.tiny(hidden_size=64, num_heads=2)
    tree = bert.init_params(np.random.default_rng(0), config)
    base = tmp_path / "bert_tiny"
    export.write_version_dir(base, 1, {"hidden_size": 64, "num_heads": 2,
                                       "vocab_size": 128, "num_layers": 2,
                                       "intermediate_size": 64,
                                       "max_position": 64},
                             export.flatten_params(tree), {"seq_len": 16})
    ids = np.random.default_rng(1).integers(0, 128, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    server = local.boot_local_server(str(base))
    try:
        before = flash_attention.launches
        out = server.core.servable.signature().run(
            {"input_ids": ids, "attention_mask": mask})
        assert flash_attention.launches == before + config.num_layers
    finally:
        local.shutdown_local_server(str(base))
    cpu = local.boot_local_server(str(base), device="cpu")
    try:
        want = cpu.core.servable.signature().run(
            {"input_ids": ids, "attention_mask": mask})
    finally:
        local.shutdown_local_server(str(base))
    np.testing.assert_allclose(out["logits"], want["logits"],
                               atol=chip_smoke.LOGITS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d, dtype", [(136, torch.bfloat16),
                                      (64, torch.float64)])
def test_gated_cuda_input_the_kernel_cannot_take_raises(card, d, dtype):
    """The dispatcher's gate is the JAX package's: a CUDA input it admits
    goes to the kernel, which raises on what it does not take, rather than
    running the plain version on the card."""
    from min_tfs_client_tpu_torch.ops.attention import attention

    q = torch.zeros((1, 2, 8, d), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="flash_attention"):
        attention(q, q, q)
