"""The port's int8 building blocks against the JAX package's, on the CPU:
the matmul recipe (ops/int8.py), the BN fold and weight quantization, the
int8 backbone and loc-net with their calibration and persisted scales
(models/resnet_int8.py), and the int8 encoder.  Weights are seeded random
draws converted by the port's weight bridge."""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multimodal_scene_text_recognition_tpu.models import resnet_int8 as jri
from multimodal_scene_text_recognition_tpu.models.encoders import (
    TransformerEncoder as JTransformerEncoder,
)
from multimodal_scene_text_recognition_tpu.models.resnet import ResNet31 as JResNet31
from multimodal_scene_text_recognition_tpu.models.transformation import (
    TPSTransform as JTPSTransform,
)
from multimodal_scene_text_recognition_tpu.ops import int8 as jint8
from multimodal_scene_text_recognition_tpu_torch.models import resnet_int8 as ri
from multimodal_scene_text_recognition_tpu_torch.models.encoders import TransformerEncoder
from multimodal_scene_text_recognition_tpu_torch.models.resnet import ResNet31
from multimodal_scene_text_recognition_tpu_torch.models.transformation import TPSTransform
from multimodal_scene_text_recognition_tpu_torch.ops import int8
from test_torch_modules import load_port, randomize

SCALES = "assets/trained/synth_openvocab_xxl.scales.npz"
RNG = np.random.default_rng(21)
IMG = RNG.random((2, 32, 100, 1), dtype=np.float32)
LAYERS = (1, 1, 1, 1)


def _matmul_inputs():
    """x [6, 64] with a zero row and a row of exact half-way ties (abs-max
    127, so the activation scale is exactly 1), w [64, 40] with a column of
    ties (abs-max 127: weight scale exactly 1), bias [40]."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 64)).astype(np.float32) * 3
    x[1] = 0.0
    x[2] = (np.arange(64) - 32 + 0.5).astype(np.float32)
    x[2, 0] = 127.0
    w = (rng.standard_normal((64, 40)) / 8).astype(np.float32)
    w[:, 3] = (np.arange(64) % 9 - 4 + 0.5).astype(np.float32)
    w[0, 3] = -127.0
    b = rng.standard_normal(40).astype(np.float32)
    return x, w, b


def test_quantize_weight_and_int8_linear_match_jax_bit_for_bit():
    """quantize_weight's int8 table and scales, the quantized activations
    (half to even on the tie rows: -30.5 -> -30, -29.5 -> -30, -0.5 -> 0) and
    int8_linear's output equal JAX's exactly; the zero row gives the
    bias."""
    x, w, b = _matmul_inputs()
    jq, js = (np.asarray(a) for a in jint8.quantize_weight(jnp.asarray(w)))
    tq, ts = int8.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert js[0, 3] == 1.0 and list(tq[1:4, 3].numpy()) == [-2, -2, 0]

    xq, _ = int8.quantize_rows(torch.from_numpy(x))
    assert list(xq[2, 1:6].numpy()) == [-30, -30, -28, -28, -26]  # -30.5 .. -26.5
    want = np.asarray(jint8.int8_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = int8.int8_linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[1].numpy(), b)


def test_div_is_the_correctly_rounded_quotient():
    """ops.int8.div gives numpy's (IEEE) float32 quotients, both ways round,
    as JAX's divisions in the quantizers do (PyTorch's ``127.0 / t`` is
    t's reciprocal times 127, a second rounding)."""
    x = torch.from_numpy(np.random.default_rng(5).uniform(1e-3, 50, 20000).astype(np.float32))
    np.testing.assert_array_equal(int8.div(127.0, x).numpy(), np.float32(127.0) / x.numpy())
    np.testing.assert_array_equal(int8.div(x, 127.0).numpy(), x.numpy() / np.float32(127.0))


def test_int_mm_is_exact():
    """The CPU route of int_mm (float64) equals the int64 product at the
    largest magnitudes, K = 4608 (a 3x3 conv over 512 channels)."""
    a = torch.full((3, 4608), -127, dtype=torch.int8)
    a[1] = 127
    b = torch.full((4608, 5), -127, dtype=torch.int8)
    b[:, 2] = 1
    got = int8.int_mm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())
    with pytest.raises(TypeError):
        int8.int_mm(a.float(), b)


@pytest.fixture(scope="module")
def resnets():
    """A narrow ResNet-31 (output channels 64, one block a stage) in both
    packages with the same seeded weights, and the JAX variables wrapped
    as the model's tree."""
    jm = JResNet31(output_channels=64, layers=LAYERS, dtype=jnp.float32, fused_bn=True)
    v = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(IMG)), 6)
    port = load_port(ResNet31(1, 64, LAYERS, torch.float32), v)
    wrapped = {"params": {"feature_extractor": v["params"]},
               "batch_stats": {"feature_extractor": v["batch_stats"]}}
    return wrapped, port


def _hwio(oihw):
    return np.transpose(oihw, (2, 3, 1, 0))


def test_bn_fold_and_quantized_tables_match_jax_bit_for_bit(resnets):
    """Every site's folded kernel and bias, int8 kernel, weight scales and
    activation scale equal JAX's exactly (the port lays kernels out OIHW)."""
    wrapped, port = resnets
    jfold = jri._conv_sites(wrapped["params"]["feature_extractor"],
                            wrapped["batch_stats"]["feature_extractor"])
    pfold = ri._conv_sites(port)
    assert sorted(jfold) == sorted(pfold) and len(pfold) == 18
    for name, (kf, bias) in pfold.items():
        np.testing.assert_array_equal(_hwio(kf), jfold[name][0], err_msg=name)
        np.testing.assert_array_equal(bias, jfold[name][1], err_msg=name)
    absmax = {name: 0.37 + 1.9 * i for i, name in enumerate(sorted(pfold))}
    jq = jri._quantize_folded(jfold, absmax)
    pq = ri._quantize_folded(pfold, absmax, torch.device("cpu"))
    for name, q in pq.items():
        j = jq[name]
        np.testing.assert_array_equal(_hwio(q.kernel_q.numpy()), np.asarray(j.kernel_q))
        np.testing.assert_array_equal(q.w_scale.numpy(), np.asarray(j.w_scale))
        np.testing.assert_array_equal(q.bias.numpy(), np.asarray(j.bias))
        assert q.x_scale.item() == float(j.x_scale) and q.x_scale.dtype == torch.float32
        assert q.kernel_q.dtype == torch.int8 and q.kernel_q.abs().max() <= 127


def test_calibration_and_int8_backbone_match_jax(resnets):
    """calibrate_resnet's abs-max per site within 1e-5 relative of JAX's
    (float32 convs summed in other orders).  With JAX's scales, the int8
    backbone output [2, 1, 26, 64] (bf16 between sites): at least 99.9% of
    elements equal, the rest within one dequantization step of the last
    site (its largest x_scale * w_scale) plus one bf16 rounding."""
    wrapped, port = resnets
    jabs = jri.calibrate_resnet(wrapped, jnp.asarray(IMG), output_channels=64, layers=LAYERS)
    pabs = ri.calibrate_resnet(port, torch.from_numpy(IMG))
    assert sorted(jabs) == sorted(pabs)
    for name in jabs:
        assert pabs[name] == pytest.approx(jabs[name], rel=1e-5), name
    jq = jri.quantize_resnet(wrapped, x_absmax=jabs, output_channels=64, layers=LAYERS)
    want = np.asarray(jax.jit(lambda q, x: jri.resnet31_int8_forward(q, x, 64, LAYERS))(
        jq, jnp.asarray(IMG))).astype(np.float32)
    pq = ri.quantize_resnet(port, x_absmax=jabs)
    got = ri.resnet31_int8_forward(pq, torch.from_numpy(IMG), 64, LAYERS)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 1, 26, 64)
    got = got.float().numpy()
    diff = np.abs(got - want)
    step = float((pq["trans4b"].x_scale * pq["trans4b"].w_scale).max())
    assert (diff == 0).mean() >= 0.999
    assert diff.max() <= step + np.abs(want).max() * 2.0 ** -8


@pytest.fixture(scope="module")
def tps_pair():
    jm = JTPSTransform(20, 32, 100, dtype=jnp.float32, fused_bn=True)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(IMG))
    port = load_port(TPSTransform(20, 32, 100, 1, torch.float32), v)
    wrapped = {"params": {"transformation": v["params"]},
               "batch_stats": {"transformation": v["batch_stats"]}}
    return wrapped, port


def test_tps_int8_rectify_matches_jax(tps_pair):
    """calibrate_tps within 1e-5 relative of JAX's; with JAX's scales the
    int8 loc-net's folded tables equal JAX's exactly, and the rectified
    crops agree within 2e-3, the float TPS tolerance (test_torch_modules:
    JAX's float32 TPS solve is off by up to 3.5e-5 in normalised
    coordinates, ~1.7e-3 pixel on these noise crops)."""
    wrapped, port = tps_pair
    jabs = jri.calibrate_tps(wrapped, jnp.asarray(IMG))
    pabs = ri.calibrate_tps(port, torch.from_numpy(IMG))
    assert sorted(pabs) == ["conv128", "conv256", "conv512", "conv64"]
    for name in jabs:
        assert pabs[name] == pytest.approx(jabs[name], rel=1e-5), name
    jq = jri.quantize_tps(wrapped, x_absmax=jabs)
    pq = ri.quantize_tps(port, x_absmax=jabs)
    for name, q in pq.items():
        np.testing.assert_array_equal(_hwio(q.kernel_q.numpy()), np.asarray(jq[name].kernel_q))
    want = np.asarray(jax.jit(lambda v, q, x: jri.tps_int8_rectify(v, q, x))(
        wrapped, jq, jnp.asarray(IMG)))
    got = ri.tps_int8_rectify(port, pq, torch.from_numpy(IMG)).numpy()
    assert got.shape == want.shape == (2, 32, 100, 1)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_scale_drift_and_persisted_scales(tmp_path):
    """check_scale_drift names the sites JAX's names and warns; scales
    round-trip through the npz both ways between the packages; the
    committed scales hold the 32 backbone and 4 loc-net sites."""
    saved = {"a": 1.0, "b": 2.0, "c": 0.0, "d": 5.0}
    observed = {"a": 2.5, "b": 3.9, "c": 1e-3, "e": 100.0}
    with pytest.warns(UserWarning, match="drifted"):
        bad = ri.check_scale_drift(saved, observed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert bad == jri.check_scale_drift(saved, observed) == ["a", "c"]
    path = str(tmp_path / "x.scales.npz")
    ri.save_activation_scales(path, saved)
    assert jri.load_activation_scales(path) == ri.load_activation_scales(path) == saved
    jri.save_activation_scales(path, observed)
    assert ri.load_activation_scales(path) == pytest.approx(observed)
    committed = ri.load_activation_scales(SCALES)
    assert committed == jri.load_activation_scales(SCALES)
    assert len(committed) == 36
    assert sorted(k for k in committed if k.startswith("tps/")) == [
        "tps/conv128", "tps/conv256", "tps/conv512", "tps/conv64"]


def test_int8_encoder_matches_jax():
    """The 2-layer encoder with encoder_int8 [2, 26, 64] (final layernorm
    output, scale ~3.6) against JAX's: within 1e-3 mean and 0.1 at most.
    A float32 difference in the attention (summation order) can move an
    activation across a rounding boundary of its int8 step, which moves a
    row of the next product by one step: rare, and bounded by the step.
    Train mode stays float: its output equals the float encoder's."""
    cols = RNG.standard_normal((2, 26, 64)).astype(np.float32)
    kw = dict(d_model=64, num_heads=4, ff_dim=128, num_layers=2, max_len=26)
    v = randomize(jax.jit(JTransformerEncoder(**kw).init)(jax.random.PRNGKey(0),
                                                          jnp.asarray(cols)), 8)
    want = np.asarray(jax.jit(JTransformerEncoder(**kw, int8=True).apply)(v, jnp.asarray(cols)))
    port = load_port(TransformerEncoder(64, 4, 128, 2, 26, int8=True), v)
    got = port(torch.from_numpy(cols)).numpy()
    diff = np.abs(got - want)
    assert diff.mean() <= 1e-3 and diff.max() <= 0.1, (diff.mean(), diff.max())
    float_port = load_port(TransformerEncoder(64, 4, 128, 2, 26), v)
    x = torch.from_numpy(cols)
    assert torch.equal(port(x, train=True), float_port(x))
    assert not torch.equal(port(x), float_port(x))
