"""Weight bridge of the PyTorch port: JAX parameter bundle -> state_dict."""

import numpy as np
import pytest
import torch

from multimodal_scene_text_recognition_tpu_torch import convert
from multimodal_scene_text_recognition_tpu_torch.config import FLAGSHIP
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel

BUNDLE = "assets/trained/synth_openvocab_xxl.params.npz"


@pytest.fixture(scope="module")
def bundle():
    return convert.load_bundle(BUNDLE)


def test_trained_bundle_fills_every_weight_once(bundle):
    """Every bundle key but __step__ lands on exactly one entry, and the
    entries are exactly the flagship's parameters and statistics, with
    matching shapes (numpy only: no forward pass)."""
    sd = convert.bundle_to_state_dict(bundle)
    assert len(bundle) == 375
    assert len(sd) == len(bundle) - len(convert.META_KEYS)
    with torch.device("meta"):
        model = SceneTextModel(FLAGSHIP)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == want[k], k
        assert v.dtype == torch.float32


def test_trained_bundle_loads_strictly(bundle):
    with torch.device("meta"):
        model = SceneTextModel(FLAGSHIP)
    model.to_empty(device="cpu")
    result = model.load_state_dict(convert.bundle_to_state_dict(bundle), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # fp16 on disk -> float32, values preserved
    np.testing.assert_array_equal(
        model.decoder.emb.weight.detach().numpy(),
        bundle["params.decoder.emb.embedding"].astype(np.float32))


@pytest.mark.parametrize(
    "key,shape,target,layout",
    [
        ("params.a.conv.kernel", (3, 2, 4, 5), "a.conv.weight", (3, 2, 0, 1)),
        ("params.a.fc.kernel", (4, 6), "a.fc.weight", (1, 0)),
        ("params.a.attn.w_qkv", (4, 12), "a.attn.in_proj_weight", (1, 0)),
        ("params.a.attn.w_out", (4, 4), "a.attn.out_proj.weight", (1, 0)),
        ("params.a.attn.b_qkv", (12,), "a.attn.in_proj_bias", None),
        ("params.a.attn.b_out", (4,), "a.attn.out_proj.bias", None),
        ("params.a.norm.scale", (4,), "a.norm.weight", None),
        ("params.a.emb.embedding", (7, 4), "a.emb.weight", None),
        ("batch_stats.a.bn.mean", (4,), "a.bn.running_mean", None),
        ("batch_stats.a.bn.var", (4,), "a.bn.running_var", None),
        # the JAX package's MLPP: a fusion MLP's layers as flat leaves
        ("params.decoder.sem_cls_mlp.fc0_kernel", (8, 4), "decoder.sem_cls_mlp.fc0.weight",
         (1, 0)),
        ("params.decoder.sem_cls_mlp.fc2_bias", (1,), "decoder.sem_cls_mlp.fc2.bias", None),
        # its MLP: one module per layer
        ("params.encoder.combine_mlp.fc1.kernel", (4, 6), "encoder.combine_mlp.fc1.weight",
         (1, 0)),
        ("params.semantic.overlap_embed.embedding", (7, 4), "semantic.overlap_embed.weight",
         None),
        ("params.semantic.scene_embed.embedding", (7, 4), "semantic.scene_embed.weight", None),
    ],
)
def test_leaf_layouts(key, shape, target, layout):
    arr = np.random.default_rng(0).standard_normal(shape).astype(np.float16)
    sd = convert.bundle_to_state_dict({key: arr, "__step__": np.int64(3)})
    want = arr.astype(np.float32)
    if layout is not None:
        want = want.transpose(layout)
    assert list(sd) == [target]
    np.testing.assert_array_equal(sd[target].numpy(), want)


@pytest.mark.parametrize("flat", [
    {"params.a.kernel_x": np.zeros(2)},          # unknown leaf
    {"batch_stats.a.scale": np.zeros(2)},        # stat leaf outside its collection
    {"params.a.mean": np.zeros(2)},
    {"opt_state.a.bias": np.zeros(2)},           # unknown collection
    {"params.a.scale": np.zeros(2), "params.a.embedding": np.zeros((2, 2))},  # collide
])
def test_rejects_keys_without_one_counterpart(flat):
    with pytest.raises(KeyError):
        convert.bundle_to_state_dict(flat)


def test_state_dict_to_bundle_semantic_leaves():
    """The semantic configuration's leaves go back to the JAX layout: the
    decoder's fusion MLPs to flat MLPP leaves (``fc0_kernel``), the
    encoder's to MLP modules (``fc0.kernel``), both transposed; the combined
    embedder's tables stay untransposed embeddings, its ``combine`` layer a
    transposed kernel; and back again unchanged."""
    rng = np.random.default_rng(1)
    sd = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          for name, shape in (("decoder.sem_cls_mlp.fc0.weight", (3, 8)),
                              ("decoder.sem_cls_mlp.fc0.bias", (3,)),
                              ("decoder.post_combine_mlp.fc2.weight", (5, 3)),
                              ("decoder.sem_to_classes.weight", (5, 4)),
                              ("encoder.sem_relevance_mlp.fc0.weight", (3, 6)),
                              ("semantic.overlap_embed.weight", (7, 4)),
                              ("semantic.scene_embed.weight", (7, 4)),
                              ("semantic.combine.weight", (4, 8)))}
    back = convert.state_dict_to_bundle(sd)
    want = {"params.decoder.sem_cls_mlp.fc0_kernel": sd["decoder.sem_cls_mlp.fc0.weight"].T,
            "params.decoder.sem_cls_mlp.fc0_bias": sd["decoder.sem_cls_mlp.fc0.bias"],
            "params.decoder.post_combine_mlp.fc2_kernel":
                sd["decoder.post_combine_mlp.fc2.weight"].T,
            "params.decoder.sem_to_classes.kernel": sd["decoder.sem_to_classes.weight"].T,
            "params.encoder.sem_relevance_mlp.fc0.kernel":
                sd["encoder.sem_relevance_mlp.fc0.weight"].T,
            "params.semantic.overlap_embed.embedding": sd["semantic.overlap_embed.weight"],
            "params.semantic.scene_embed.embedding": sd["semantic.scene_embed.weight"],
            "params.semantic.combine.kernel": sd["semantic.combine.weight"].T}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    again = convert.bundle_to_state_dict(back)
    assert set(again) == set(sd)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k


def test_state_dict_to_bundle_inverts_the_bridge(bundle):
    """The trained bundle -> state_dict -> bundle gives back every key but
    __step__, with equal float32 values (conv kernels back to HWIO, dense
    kernels and packed projections back to [in, out], embeddings and norm
    scales told apart)."""
    back = convert.state_dict_to_bundle(convert.bundle_to_state_dict(bundle))
    assert set(back) == set(bundle) - set(convert.META_KEYS)
    for k, v in back.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, bundle[k].astype(np.float32), err_msg=k)
    with pytest.raises(KeyError):
        convert.state_dict_to_bundle({"a.num_batches_tracked": torch.zeros(())})


def test_fusion_site_bundle_round_trip():
    """A JAX model with all three per-layer fusion sites (and every other
    fusion hook): its variables (``jax.eval_shape`` of ``init``, seeded
    draws) convert into the port's state_dict, load strictly, and
    ``state_dict_to_bundle`` gives every key back with equal values: each
    layer's ``mha_<site>`` packed projections and its ``mlp_<site>`` flat
    MLPP leaves (``fc<i>_kernel``/``fc<i>_bias``) among them."""
    import jax

    from multimodal_scene_text_recognition_tpu.core.config import ModelConfig as JModelConfig
    from multimodal_scene_text_recognition_tpu.models.model import build_model
    from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig
    from test_torch_model import SMALL
    from test_torch_modules import flatten
    from test_torch_semantic import variables

    flags = dict(semantic_vector="combined", pre_encoder_mlp=True, pre_decoder_mlp=True,
                 cls_decoder_init=True, post_decoder_mlp=True, multihead_pre_target=True,
                 multihead_pre_memory=True, multihead_post_memory=True)
    jm = build_model(JModelConfig(**SMALL, **flags))
    k = jax.random.PRNGKey(0)
    B = 2
    v = variables(jm.init, 61, {"params": k, "dropout": k, "semantics": k},
                  np.zeros((B, 32, 100, 1), np.float32), np.zeros((B, 26), np.int32),
                  np.zeros((B, 15), np.int32), np.zeros((B, 52), np.int32),
                  np.zeros((B, 52), np.float32), train=True)
    flat = flatten(v)
    for site in ("pre_target", "pre_memory", "post_memory"):
        assert {f"params.decoder.layer1.mha_{site}.w_qkv",
                f"params.decoder.layer1.mha_{site}.b_out",
                f"params.decoder.layer1.mlp_{site}.fc0_kernel",
                f"params.decoder.layer1.mlp_{site}.fc2_bias"} <= set(flat)
    sd = convert.bundle_to_state_dict(flat)
    assert sd["decoder.layer0.mlp_pre_target.fc0.weight"].shape == (SMALL["embed_dim"],
                                                                     2 * SMALL["embed_dim"])
    model = SceneTextModel(ModelConfig(**SMALL, **flags))
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = convert.state_dict_to_bundle(model.state_dict())
    assert set(back) == set(flat)
    for key, arr in back.items():
        np.testing.assert_array_equal(arr, flat[key], err_msg=key)
