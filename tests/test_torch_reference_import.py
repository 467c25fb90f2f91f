"""The PyTorch port's import of a reference ``.pth``
(``train/torch_import.convert_state_dict``,
``train/checkpoint.import_torch_checkpoint``) against the JAX package's
``train/torch_import.convert_state_dict`` on the CPU, float32.

For each configuration a reference-layout state dict is made from a JAX
variables tree by inverting each transform that JAX ``torch_key_for``
names (with nn.DataParallel's ``module.`` prefix, keys the import ignores
and one it does not know), fed to both imports over the same starting
weights, and the two models' greedy logits are compared, with the import
stats field by field."""

import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.train import torch_import as jimport
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
from multimodal_scene_text_recognition_tpu_torch.train import torch_import
from multimodal_scene_text_recognition_tpu_torch.train.checkpoint import import_torch_checkpoint
from test_torch_model import SMALL
from test_torch_modules import flatten
from test_torch_variants import fast_variables, init_shapes, model_inputs, port_model
import torch_threads

torch_threads.limit()

SITES = dict(semantic_vector="combined", pre_encoder_mlp=True, pre_decoder_mlp=True,
             cls_decoder_init=True, post_decoder_mlp=True, multihead_pre_target=True,
             multihead_pre_memory=True, multihead_post_memory=True)
NO_TPS = dict(SMALL, use_tps=False)
# name: (configuration, limit on max |port - jax| / max(1, max |jax|))
CONFIGS = {
    # JAX's float32 TPS solve moves the sample points by up to 3.5e-5
    # (tests/test_torch_ops.py) and the backbone carries the pixel
    # differences into the logits: measured 3.4e-6
    "flagship shape": (dict(SMALL), 1e-4),
    # every fusion hook and the three layer sites, the linear embedder:
    # measured 5.4e-7
    "hooks and sites": (dict(NO_TPS, enc_layers=1, dec_layers=1, **SITES), 1e-5),
    # measured 1.2e-7 and 2.4e-7
    "BiLSTM-Attn": (dict(NO_TPS, encoder="lstm", decoder="lstm", lstm_hidden=48), 1e-5),
    "BiLSTM-CTC": (dict(NO_TPS, encoder="lstm", decoder="linear", label_codec="ctc",
                        lstm_hidden=48), 1e-5),
    # the Oscar encoder and the BERT embedder at their fixed widths, on
    # tag token rows: measured 7.9e-7
    "Oscar-BERT": (dict(NO_TPS, encoder="oscar", oscar_encoder=True,
                        semantic_embedding="bert", cls_decoder_init=True), 1e-5),
}
B = 3
EMBED = "get_semantic_vectors.embed.weight"  # the table the reference loader skips


def reference_state_dict(variables, prefix="module."):
    """The reference's state dict that JAX ``convert_state_dict`` maps onto
    ``variables``: each leaf with a torch key through the inverse of its
    transform (a packed q/k/v split back into three), as torch tensors,
    plus a BatchNorm counter, a clone prototype's weight (both ignored) and
    a key no model has."""
    sd = {}
    for key, arr in flatten(variables).items():
        collection, *path = key.split(".")
        km = jimport.torch_key_for(collection, tuple(path))
        if km is None:
            continue
        tkey, transform = km
        name = transform.__name__
        if name in ("_t_qkv_w", "_t_qkv_b"):
            parts = np.split(arr, len(tkey), axis=-1)
            for k, part in zip(tkey, parts):
                sd[prefix + k] = part.T if name == "_t_qkv_w" else part
            continue
        sd[prefix + tkey] = {"_t_linear": lambda a: a.T,
                             "_t_conv": lambda a: a.transpose(3, 2, 0, 1)}.get(
                                 name, lambda a: a)(arr)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}
    sd[prefix + "FeatureExtraction.ConvNet.bn0_1.num_batches_tracked"] = torch.tensor(7)
    sd[prefix + "decoder.decoder_layer.linear1.weight"] = torch.ones(4, 4)
    sd[prefix + "not_a_module.weight"] = torch.ones(2)
    return sd


def _inputs(kw, seed):
    img, ov = model_inputs(seed, bert=kw.get("semantic_embedding") == "bert")
    rng = np.random.default_rng(seed)
    sc = rng.integers(1, 2000, (B, 52)).astype(np.int32)
    sc[:, 20:] = 0
    io = np.where(sc > 0, rng.random((B, 52)), -1000.0).astype(np.float32)
    return img, ov, sc, io


@pytest.mark.parametrize("name", list(CONFIGS))
def test_import_matches_jax(name, tmp_path):
    """Both imports of one reference state dict over the same starting
    weights (a second seeded draw, so that every imported entry changes):
    the stats equal JAX's field by field with ``skip_semantic_embed`` True
    and False, and the greedy (or CTC column) logits of the two imported
    models agree within the configuration's limit, with the same argmax.
    For the flagship's shape the dict also goes through a ``.pth`` file
    and the port's ``import_torch_checkpoint``, which gives the same
    model."""
    kw, rel = CONFIGS[name]
    jm = build_model(JModelConfig(**kw))
    shapes = init_shapes(jm)
    v = fast_variables(jm, 61, shapes)
    sd = reference_state_dict(fast_variables(jm, 62, shapes))
    model = port_model(ModelConfig(**kw, decode_fused=True), v)
    for skip in (False, True):
        jvars, jstats = jimport.convert_state_dict(sd, v, skip_semantic_embed=skip)
        state, stats = torch_import.convert_state_dict(sd, model, skip_semantic_embed=skip)
        assert stats == jstats
    embed = [EMBED] if "module." + EMBED in sd else []
    assert stats["loaded"] > 0 and stats["skipped"] == embed
    assert stats["unused_torch_keys"] == embed + ["not_a_module.weight"]

    if name == "flagship shape":
        path = tmp_path / "ref.pth"
        torch.save(sd, path)
        assert import_torch_checkpoint(str(path), model) == jstats
        for k, t in model.state_dict().items():
            torch.testing.assert_close(t, state[k], atol=0, rtol=0, msg=k)
    else:
        model.load_state_dict(state, strict=True)

    img, ov, sc, io = _inputs(kw, 63)
    want = np.asarray(jax.jit(functools.partial(jm.apply, train=False))(
        jvars, img, None, ov, sc, io))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(ov).long(),
                    scene=torch.from_numpy(sc).long(), ious=torch.from_numpy(io)).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, f"{name}: {err}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def small_pair():
    kw = dict(NO_TPS, enc_layers=1, dec_layers=1)
    jm = build_model(JModelConfig(**kw))
    v = fast_variables(jm, 64)
    return v, port_model(ModelConfig(**kw, decode_fused=True), v)


def test_wrong_shape_raises_as_jax(small_pair):
    """An entry of another shape raises ValueError in both imports, naming
    the key; the port's model is not touched."""
    v, model = small_pair
    sd = reference_state_dict(v)
    sd["module.decoder.hid_to_emb.weight"] = torch.zeros(7, 7)
    with pytest.raises(ValueError, match="shape mismatch decoder.hid_to_emb.weight"):
        jimport.convert_state_dict(sd, v)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch decoder.hid_to_emb.weight"):
        torch_import.convert_state_dict(sd, model)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_strict_raises_on_a_dropped_key_as_jax(small_pair, tmp_path):
    """With ``strict=True`` a key the map names and the dict lacks raises
    KeyError in both imports (and through ``import_torch_checkpoint``);
    without it the entry is reported missing and keeps its value."""
    v, model = small_pair
    sd = reference_state_dict(v)
    del sd["module.decoder.emb.weight"]
    with pytest.raises(KeyError):
        jimport.convert_state_dict(sd, v, strict=True)
    with pytest.raises(KeyError):
        torch_import.convert_state_dict(sd, model, strict=True)
    path = tmp_path / "ref.pth"
    torch.save(sd, path)
    with pytest.raises(KeyError):
        import_torch_checkpoint(str(path), model, strict=True)
    _, jstats = jimport.convert_state_dict(sd, v)
    state, stats = torch_import.convert_state_dict(sd, model)
    assert stats == jstats and stats["missing"] == ["params/decoder/emb/embedding"]
    assert torch.equal(state["decoder.emb.weight"], model.state_dict()["decoder.emb.weight"])
