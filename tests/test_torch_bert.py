"""The port's BERT layers and model (min_tfs_client_tpu_torch.models) held
against the JAX package's on the CPU, with the same numpy-made inputs and
the JAX package's own parameters carried across by `params_from_jax`.

Tolerances: float32 paths 1e-6; single bf16 layers 1.6e-2 (one bf16 ulp of
values up to 4). Tiny-BERT logits 3e-2 and probabilities 1e-2: the port's
gelu rounds to bf16 once (F.gelu), XLA's after each of its elementwise ops,
and that difference passes through every layer (2e-2 was the largest gap
seen over eight seeds). Argmax must agree wherever the two logits of a row
are further apart than twice the logits tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from min_tfs_client_tpu.models import bert as jbert
from min_tfs_client_tpu.models import layers as jlayers
from min_tfs_client_tpu_torch.models import bert as tbert
from min_tfs_client_tpu_torch.models import export as texport
from min_tfs_client_tpu_torch.models import layers as tlayers

LOGITS_TOL = 3e-2
PROBS_TOL = 1e-2
BF16_LAYER_TOL = 1.6e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_tree(seed, config):
    return jbert.init_params(jax.random.PRNGKey(seed), config)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("ids", [[-1, -7, 5, 99], [0, 4, -5, -6],
                                 [[3, 1000], [-1000, 2]]])
def test_embed_wraps_then_clamps_like_jax(ids):
    table = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    ids = np.asarray(ids, np.int32)
    want = jlayers.embed({"embedding": jnp.asarray(table)}, jnp.asarray(ids))
    got = tlayers.embed({"embedding": torch.from_numpy(table)},
                        torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_embed_rule_on_a_five_row_table():
    table = torch.arange(5, dtype=torch.float32)[:, None]
    got = tlayers.embed({"embedding": table},
                        torch.tensor([-1, -7, 5, 99]))
    assert got[:, 0].tolist() == [4, 0, 4, 4]


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert abs(float(tlayers.gelu_tanh(torch.tensor(1.0))) - 0.841192) < 1e-5
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = jlayers.layer_norm({"scale": jnp.asarray(scale),
                               "bias": jnp.asarray(bias)},
                              jnp.asarray(x, dtype), eps=1e-12)
    got = tlayers.layer_norm({"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)},
                             torch.from_numpy(x).to(getattr(torch, dtype)),
                             eps=1e-12)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else BF16_LAYER_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_dense_and_mha_match_jax():
    config = jbert.BertConfig.tiny()
    tree = _jax_tree(0, config)
    port = texport.params_from_jax(_numpy_tree(tree), tbert.BertConfig.tiny(),
                                  device="cpu")
    layer, port_layer = tree["layers"][0], port["layers"][0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 12, config.hidden_size)).astype(np.float32)
    lens = np.asarray([12, 4, 7], np.int32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    np.testing.assert_allclose(
        _np(tlayers.dense(port_layer["mlp"]["wi"], tx)),
        _np(jlayers.dense(layer["mlp"]["wi"], jx)),
        atol=BF16_LAYER_TOL, rtol=BF16_LAYER_TOL)
    want, _ = jlayers.mha(layer["attention"], jx, num_heads=config.num_heads,
                          lengths=jnp.asarray(lens))
    got = tlayers.mha(port_layer["attention"], tx,
                      num_heads=config.num_heads,
                      lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_LAYER_TOL,
                               rtol=BF16_LAYER_TOL)


def test_lengths_from_mask():
    mask = np.asarray([[1, 1, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]], np.int32)
    want = jlayers.lengths_from_mask(jnp.asarray(mask))
    got = tlayers.lengths_from_mask(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch(seed, config, batch=8, seq=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, config.vocab_size, (batch, seq)).astype(np.int32)
    lens = rng.integers(1, seq + 1, batch)
    lens[0] = seq
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiny_bert_logits_and_probabilities(seed):
    config = jbert.BertConfig.tiny()
    port_config = tbert.BertConfig.tiny()
    assert dataclasses.asdict(port_config) == dataclasses.asdict(config)
    tree = _jax_tree(seed, config)
    port = texport.params_from_jax(_numpy_tree(tree), port_config,
                                  device="cpu")
    ids, mask = _batch(seed, config)
    want = np.asarray(jbert.logits_fn(tree, config, jnp.asarray(ids),
                                      jnp.asarray(mask)))
    got = tbert.logits_fn(port, port_config, torch.from_numpy(ids),
                          torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (8, config.num_labels)
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(
        torch.softmax(torch.from_numpy(got), -1).numpy(),
        np.asarray(jax.nn.softmax(jnp.asarray(want), axis=-1)),
        atol=PROBS_TOL, rtol=0)
    clear = np.abs(want[:, 0] - want[:, 1]) > 2 * LOGITS_TOL
    assert clear.sum() >= 4
    np.testing.assert_array_equal(got[clear].argmax(-1),
                                  want[clear].argmax(-1))


def test_params_from_jax_takes_an_npz_tree(tmp_path):
    """The tree unflatten_params rebuilds from a params.npz (lists for the
    layers) carries across like the init tree, including bf16 leaves."""
    config = tbert.BertConfig.tiny(num_layers=1)
    tree = _numpy_tree(_jax_tree(3, jbert.BertConfig.tiny(num_layers=1)))
    flat = texport.flatten_params(tree)
    flat["pooler.kernel"] = np.asarray(
        jnp.asarray(flat["pooler.kernel"], jnp.bfloat16))
    np.savez(tmp_path / "params.npz", **flat)
    loaded = texport.load_params(tmp_path / "params.npz")
    assert loaded["pooler"]["kernel"].dtype == torch.bfloat16
    port = texport.params_from_jax(loaded, config, device="cpu")
    np.testing.assert_array_equal(
        _np(port["pooler"]["kernel"]),
        _np(jnp.asarray(tree["pooler"]["kernel"], jnp.bfloat16)))
    assert port["layers"][0]["attention_norm"]["scale"].dtype == torch.float32


def test_numpy_init_has_the_jax_tree_layout():
    config = tbert.BertConfig.tiny()
    want = texport.flatten_params(_numpy_tree(_jax_tree(
        0, jbert.BertConfig.tiny())))
    got = texport.flatten_params(tbert.init_params(
        np.random.default_rng(0), config))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == np.float32, key
    kernel = got["layers.0.mlp.wi.kernel"]
    assert abs(kernel.std() * np.sqrt(config.hidden_size) - 1) < 0.1


def test_unported_options_raise_naming_the_slice():
    config = tbert.BertConfig.tiny()
    tree = _numpy_tree(_jax_tree(0, jbert.BertConfig.tiny()))
    port = texport.params_from_jax(tree, config, device="cpu")
    for kw in ({"long_context_seq": 32}, {"pipeline_mesh": object()},
               {"seq_buckets": (8, 16)}):
        with pytest.raises(NotImplementedError, match="slice"):
            tbert.build_signatures(port, config, seq_len=16, device="cpu",
                                   **kw)
    moe = dataclasses.replace(config, moe_experts=2)
    with pytest.raises(NotImplementedError, match="slice"):
        tbert.init_params(np.random.default_rng(0), moe)
    with pytest.raises(NotImplementedError, match="slice"):
        texport.params_from_jax(tree, moe, device="cpu")
