"""Modules of the PyTorch port against their JAX counterparts, float32 on
the CPU, with seeded random weights converted by the port's weight bridge.

Each comparison asserts max |port - jax| <= 1e-4 * max(1, max |jax|); the
docstrings state each output's scale (max |jax|) and the difference
measured when the test was written."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models.decoders import (
    TransformerDecoder as JTransformerDecoder,
)
from multimodal_scene_text_recognition_tpu.models.encoders import (
    TransformerEncoder as JTransformerEncoder,
)
from multimodal_scene_text_recognition_tpu.models.resnet import ResNet31 as JResNet31
from multimodal_scene_text_recognition_tpu.models.resnet import (
    to_column_sequence as j_to_column_sequence,
)
from multimodal_scene_text_recognition_tpu.models.transformation import (
    LocalizationNetwork as JLocalizationNetwork,
    TPSTransform as JTPSTransform,
)
from multimodal_scene_text_recognition_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from multimodal_scene_text_recognition_tpu_torch import convert
from multimodal_scene_text_recognition_tpu_torch.models.decoders import TransformerDecoder
from multimodal_scene_text_recognition_tpu_torch.models.encoders import TransformerEncoder
from multimodal_scene_text_recognition_tpu_torch.models.resnet import (
    ResNet31,
    to_column_sequence,
)
from multimodal_scene_text_recognition_tpu_torch.models.transformation import (
    LocalizationNetwork,
    TPSTransform,
)
from multimodal_scene_text_recognition_tpu_torch.ops import tps
import torch_threads

torch_threads.limit()


def randomize(variables, seed):
    """Replace every leaf of a flax variables tree with a seeded draw of the
    same shape: kernels ~ N(0, 1/fan_in), norm scales ~ 1 + N(0, 0.1),
    biases and running means ~ N(0, 0.1), running variances ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, variables)


def flatten(variables):
    """A flax variables tree as the flat dotted-key bundle layout."""
    flat = {}
    for coll, tree in variables.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[".".join([coll] + [str(k.key) for k in path])] = np.asarray(leaf)
    return flat


def load_port(module, variables):
    """Load converted flax variables into a port module, strictly."""
    module.load_state_dict(convert.bundle_to_state_dict(flatten(variables)), strict=True)
    return module.eval().requires_grad_(False)


def assert_close_to_scale(got, want, rel=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape
    assert err <= rel * scale, f"max |diff| {err} > {rel} * scale {scale}"


RNG = np.random.default_rng(11)
IMG = RNG.random((2, 32, 100, 1), dtype=np.float32)


def test_localization_network():
    """Fiducials [2, 20, 2]: scale 0.62, measured difference 2e-7."""
    jm = JLocalizationNetwork(20, dtype=jnp.float32, fused_bn=True)
    v = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(IMG)), 1)
    want = np.asarray(jm.apply(v, jnp.asarray(IMG)))
    port = load_port(LocalizationNetwork(20, 1, torch.float32), v)
    got = port(torch.from_numpy(IMG).permute(0, 3, 1, 2)).numpy()
    assert_close_to_scale(got, want)


@pytest.mark.parametrize("fiducial_noise", [0.0, 1.0])
def test_tps_transform(fiducial_noise):
    """Rectified crops [2, 32, 100, 1] in [0, 1].  Noise 0 keeps the fiducial
    head at its identity warp; noise 1 randomizes every weight, so the grid
    runs outside [-1, 1] and exercises the border clamp.

    Against JAX's fiducials, solved exactly (float64 TPS weights) and warped
    by JAX's grid_sample at HIGHEST: 1e-4.  Against the JAX module as a
    whole: atol 2e-3, the warp of JAX's own grid error: its float32 solve is
    off by up to 3.5e-5 in normalised coordinates (see test_torch_ops), i.e.
    1.7e-3 pixel across a 100-wide crop, and these noise crops change by up
    to 1 between neighbouring pixels."""
    jm = JTPSTransform(20, 32, 100, dtype=jnp.float32, fused_bn=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(IMG))
    if fiducial_noise:
        v = randomize(v, 2)
    port = load_port(TPSTransform(20, 32, 100, 1, torch.float32), v)
    got = port(torch.from_numpy(IMG)).numpy()

    loc = JLocalizationNetwork(20, dtype=jnp.float32, fused_bn=True)
    fid = np.asarray(loc.apply({c: t["loc_net"] for c, t in v.items()}, jnp.asarray(IMG)))
    grid = np.einsum("nf,bfk->bnk", tps.tps_weights(20, 32, 100).astype(np.float64),
                     fid.astype(np.float64)).reshape(2, 32, 100, 2).astype(np.float32)
    exact = np.asarray(jax_grid_sample(jnp.asarray(IMG), jnp.asarray(grid),
                                       precision=jax.lax.Precision.HIGHEST))
    assert_close_to_scale(got, exact)
    want = np.asarray(jm.apply(v, jnp.asarray(IMG)))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_resnet31_columns():
    """Column features [2, 26, 64] after to_column_sequence (full depth,
    narrow widths 16/32/64/64): scale 1.5, measured difference 1.4e-6."""
    jm = JResNet31(output_channels=64, dtype=jnp.float32, fused_bn=True)
    v = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(IMG)), 3)
    want = np.asarray(j_to_column_sequence(jm.apply(v, jnp.asarray(IMG))))
    port = load_port(ResNet31(1, 64, dtype=torch.float32), v)
    got = to_column_sequence(port(torch.from_numpy(IMG).permute(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 26, 64)
    assert_close_to_scale(got, want)


def test_transformer_encoder():
    """Encoded columns [2, 26, 64] (final layernorm output): scale 3.6,
    measured difference 1.4e-6."""
    cols = RNG.standard_normal((2, 26, 64)).astype(np.float32)
    jm = JTransformerEncoder(d_model=64, num_heads=4, ff_dim=128, num_layers=2, max_len=26)
    v = randomize(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(cols)), 4)
    want = np.asarray(jm.apply(v, jnp.asarray(cols)))
    port = load_port(TransformerEncoder(64, 4, 128, 2, 26), v)
    got = port(torch.from_numpy(cols)).numpy()
    assert_close_to_scale(got, want)


def test_transformer_decoder_greedy():
    """Greedy logits [3, 25, 97]: the port's fused loop (plain version on
    the CPU) against the JAX scan decode, which equals the JAX fused kernel
    in float32.  Scale 3.4, measured difference 1.7e-6; tokens identical."""
    B, H, E = 3, 64, 32
    enc = RNG.standard_normal((B, 26, H)).astype(np.float32)
    jm = JTransformerDecoder(num_classes=97, d_model=E, memory_dim=H, num_heads=4,
                             ff_dim=64, num_layers=2, dropout=0.0, max_text_length=25)
    rng = jax.random.PRNGKey(0)
    v = jm.init({"params": rng, "dropout": rng}, jnp.asarray(enc),
                jnp.zeros((B, 26), jnp.int32), None, train=True)
    v = randomize(v, 5)
    want = np.asarray(jm.apply(v, jnp.asarray(enc), None, None, train=False))
    port = load_port(TransformerDecoder(97, E, H, 4, 64, 2, 25, torch.float32), v)
    got = port.greedy_decode(torch.from_numpy(enc)).numpy()
    assert_close_to_scale(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
