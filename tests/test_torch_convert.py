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
