"""Int8 post-training-quantized ResNet-31 backbone and TPS loc-net for
serving (JAX counterpart: models/resnet_int8.py).

* BatchNorm is an affine at eval time, folded into each conv's weights
  (per-output-channel scale) and a bias, in numpy float32 as the JAX
  package folds it;
* weights: symmetric per-output-channel int8 (abs-max / 127);
* activations: symmetric per-tensor int8 with STATIC scales, the abs-max of
  each conv input over a calibration batch (persisted beside the bundle as
  ``<bundle>.scales.npz``: site names as keys, the loc-net's under
  ``tps/``);
* each conv is an exact int8 x int8 -> int32 product: the input patches
  gathered into int8 rows (im2col, channels last) times the [kh*kw*ci, co]
  int8 matrix, through ``ops/int8.int_mm`` (``torch._int_mm`` on the card,
  which has no int8 convolution; float64 on the CPU).  Dequantization,
  bias, residual and ReLU run in float32; the activations between sites
  are stored bf16.

The graph mirrors models/resnet.ResNet31 (channels last, [B, H, W, C], as
the JAX package lays it out); site names are the JAX package's (``stem0``,
``block1_0/conv1``, ``block3_0/downsample_conv``, ...).  The two
quantizers differ as the JAX package's do: the backbone multiplies by
``1 / x_scale``, the loc-net divides by ``x_scale``.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import tps as tps_ops
from ..ops.grid_sample import grid_sample
from ..ops.int8 import dequantize, div, int_mm
from ..ops.precision import full_fp32
from .layers import EPS


class QConv(NamedTuple):
    """One BN-folded, weight-quantized conv site."""

    kernel_q: torch.Tensor  # int8 [co, ci, kh, kw] (kernel = kernel_q * w_scale)
    w_scale: torch.Tensor   # float32 [co]
    bias: torch.Tensor      # float32 [co] (the folded BN shift)
    x_scale: torch.Tensor   # float32 scalar (activation step: absmax / 127)
    matrix_t: torch.Tensor  # int8 [co, kh*kw*ci], kernel_q in im2col order


Folded = Dict[str, Tuple[np.ndarray, np.ndarray]]  # site -> (f32 OIHW kernel, bias)


def _fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=EPS):
    """conv(x, W) -> BN == conv(x, W * a) + c, a and c per output channel
    (kernel [co, ci, kh, kw])."""
    a = bn_scale / np.sqrt(bn_var + eps)
    return kernel * a[:, None, None, None], bn_bias - bn_mean * a


def _fold(conv, bn):
    def f32(t):
        return t.detach().cpu().float().numpy()

    return _fold_bn(f32(conv.weight), f32(bn.weight), f32(bn.bias),
                    f32(bn.running_mean), f32(bn.running_var))


def _plan(layers: Sequence[int]):
    """Execution plan of ResNet31.forward (kept in lockstep with it):
    ("conv", site, (kh, kw), stride, (pad_h, pad_w)), ("pool", window,
    stride, (pad_h, pad_w)) or ("block", name)."""
    return [
        ("conv", "stem0", (3, 3), (1, 1), (1, 1)),
        ("conv", "stem1", (3, 3), (1, 1), (1, 1)),
        ("pool", (2, 2), (2, 2), (0, 0)),
        *[("block", f"block1_{i}") for i in range(layers[0])],
        ("conv", "trans1", (3, 3), (1, 1), (1, 1)),
        ("pool", (2, 2), (2, 2), (0, 0)),
        *[("block", f"block2_{i}") for i in range(layers[1])],
        ("conv", "trans2", (3, 3), (1, 1), (1, 1)),
        ("pool", (2, 2), (2, 1), (0, 1)),
        *[("block", f"block3_{i}") for i in range(layers[2])],
        ("conv", "trans3", (3, 3), (1, 1), (1, 1)),
        *[("block", f"block4_{i}") for i in range(layers[3])],
        ("conv", "trans4a", (2, 2), (2, 1), (0, 1)),
        ("conv", "trans4b", (2, 2), (1, 1), (0, 0)),
    ]


def _conv_sites(resnet) -> Folded:
    """Site name -> folded float32 kernel and bias for every conv of a
    ``models.resnet.ResNet31``, under the JAX package's site names."""
    sites = {}
    for name, mod in resnet.named_children():
        if name.endswith("_conv"):
            site = name[: -len("_conv")]
            sites[site] = _fold(mod, getattr(resnet, f"{site}_bn"))
        elif name.startswith("block"):
            for c, b in (("conv1", "bn1"), ("conv2", "bn2"),
                         ("downsample_conv", "downsample_bn")):
                if hasattr(mod, c):
                    sites[f"{name}/{c}"] = _fold(getattr(mod, c), getattr(mod, b))
    return sites


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _im2col(x: torch.Tensor, kernel, stride, padding) -> torch.Tensor:
    """x [B, H, W, C] -> the patches of a (kh, kw) conv [B, Ho, Wo, kh*kw*C],
    ordered (i, j, c)."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    B, H, W, C = x.shape
    Ho, Wo = (H - kh) // sh + 1, (W - kw) // sw + 1
    if (kh, kw) == (1, 1):
        return x[:, ::sh, ::sw]
    taps = [x[:, i:i + sh * (Ho - 1) + 1:sh, j:j + sw * (Wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(B, Ho, Wo, kh * kw * C)


def conv_int8(hq: torch.Tensor, q: QConv, stride, padding) -> torch.Tensor:
    """The exact int32 conv of int8 ``hq`` [B, H, W, ci] with the site's
    int8 kernel -> [B, Ho, Wo, co]."""
    cols = _im2col(hq, q.kernel_q.shape[2:], stride, padding)
    B, Ho, Wo, K = cols.shape
    out = int_mm(cols.reshape(B * Ho * Wo, K), q.matrix_t.t())
    return out.reshape(B, Ho, Wo, -1)


def _conv_f32(h: torch.Tensor, kf: torch.Tensor, bias: torch.Tensor, stride, padding):
    return _nhwc(F.conv2d(_nchw(h), kf, stride=stride, padding=padding)) + bias


def _max_pool(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    # max_pool2d pads with -inf, as the JAX package's reduce_window does
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, padding))


def _record(record: Dict[str, float], name: str, h: torch.Tensor) -> None:
    record[name] = max(record.get(name, 0.0), float(h.abs().max()))


def _sites_on(folded: Folded, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    return {k: (torch.from_numpy(kf).to(device), torch.from_numpy(b).to(device))
            for k, (kf, b) in folded.items()}


def _forward(sites: Dict, x: torch.Tensor, oc: int, layers: Sequence[int],
             record: Optional[Dict[str, float]] = None,
             act_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mirror of ResNet31.forward on [B, H, W, C] tensors.  ``sites`` maps
    a site to (float32 kernel, bias) in calibration mode (``record``
    collects each site's input abs-max) or to a :class:`QConv` in int8 mode
    (activations between sites stored in ``act_dtype``)."""

    def site_conv(h, name, stride=(1, 1), padding=(1, 1), relu=True):
        s = sites[name]
        if record is not None:
            _record(record, name, h)
            out = _conv_f32(h, *s, stride, padding)
        else:
            inv = div(1.0, s.x_scale)
            hq = torch.clamp(torch.round(h.float() * inv), -127, 127).to(torch.int8)
            out = dequantize(conv_int8(hq, s, stride, padding), s.x_scale, s.w_scale,
                             s.bias).to(act_dtype)
        return torch.relu(out) if relu else out

    def block(h, name, planes):
        residual = h
        out = site_conv(h, f"{name}/conv1")
        out = site_conv(out, f"{name}/conv2", relu=False)
        if h.shape[-1] != planes:
            residual = site_conv(h, f"{name}/downsample_conv", padding=(0, 0), relu=False)
        return torch.relu(out.float() + residual.float()).to(act_dtype)

    stage_ch = (oc // 4, oc // 2, oc, oc)
    x = x.float()
    for op in _plan(layers):
        if op[0] == "conv":
            _, name, _, stride, padding = op
            x = site_conv(x, name, stride, padding)
        elif op[0] == "pool":
            x = _max_pool(x, *op[1:])
        else:
            name = op[1]
            x = block(x, name, stage_ch[int(name[5]) - 1])
    return x


def _geometry(resnet):
    return resnet.trans4b_conv.out_channels, resnet.layers


@torch.no_grad()
def calibrate_resnet(resnet, calib_images: torch.Tensor) -> Dict[str, float]:
    """Per-site input abs-max of a ``models.resnet.ResNet31`` over a
    calibration batch of backbone INPUTS, the TPS-rectified crops [B, H, W,
    1], in full float32."""
    oc, layers = _geometry(resnet)
    record: Dict[str, float] = {}
    with full_fp32():
        _forward(_sites_on(_conv_sites(resnet), calib_images.device), calib_images,
                 oc, layers, record=record)
    return record


def save_activation_scales(path: str, scales: Dict[str, float]) -> None:
    """Persist calibration abs-max values (a small npz beside the bundle)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, names=np.asarray(sorted(scales)),
             values=np.asarray([scales[k] for k in sorted(scales)], np.float32))


def load_activation_scales(path: str) -> Dict[str, float]:
    z = np.load(path, allow_pickle=False)
    return {str(n): float(v) for n, v in zip(z["names"], z["values"])}


def check_scale_drift(saved: Dict[str, float], observed: Dict[str, float],
                      threshold: float = 2.0):
    """Warn when observed activation ranges exceed the calibrated ones by
    more than ``threshold`` (int8 clipping: silent accuracy loss).  Returns
    the offending site names."""
    bad = [name for name in saved
           if name in observed
           and max(observed[name], 1e-12) / max(saved[name], 1e-12) > threshold]
    if bad:
        warnings.warn(
            f"int8 activation ranges drifted >{threshold}x past calibration "
            f"at {len(bad)} conv sites (e.g. {bad[:3]}); recalibrate on "
            "representative data (eval/serve.Recognizer.calibrate_int8)")
    return bad


def _quantize_folded(folded: Folded, x_absmax: Dict[str, float], device) -> Dict[str, QConv]:
    """Per-channel weight quantization and the static activation scale of
    each site, in numpy float32 as the JAX package computes them."""
    qsites = {}
    for name, (kf, bias) in folded.items():
        absmax = np.abs(kf).max(axis=(1, 2, 3))
        w_scale = np.maximum(absmax, 1e-12) / 127.0
        kq = np.clip(np.round(kf / w_scale[:, None, None, None]), -127, 127).astype(np.int8)
        x_scale = np.float32(max(x_absmax[name] / 127.0, 1e-12))
        kq_t = torch.from_numpy(kq).to(device)
        qsites[name] = QConv(
            kernel_q=kq_t,
            w_scale=torch.from_numpy(w_scale.astype(np.float32)).to(device),
            bias=torch.from_numpy(bias.astype(np.float32)).to(device),
            x_scale=torch.tensor(x_scale, device=device),
            matrix_t=kq_t.permute(0, 2, 3, 1).reshape(kq.shape[0], -1).contiguous())
    return qsites


def quantize_resnet(resnet, x_absmax: Dict[str, float]) -> Dict[str, QConv]:
    """PTQ of a trained ``models.resnet.ResNet31``: activation scales from
    ``x_absmax`` (a :func:`calibrate_resnet` result, perhaps persisted);
    site -> QConv on the module's device."""
    return _quantize_folded(_conv_sites(resnet), x_absmax, resnet.stem0_conv.weight.device)


@torch.no_grad()
def resnet31_int8_forward(qsites: Dict[str, QConv], x: torch.Tensor,
                          output_channels: int = 512, layers: Sequence[int] = (1, 2, 5, 3),
                          act_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Int8 inference forward: [B, 32, 100, 1] -> [B, 1, W/4+1, oc] in
    ``act_dtype`` (channels last)."""
    return _forward(qsites, x, output_channels, layers, act_dtype=act_dtype)


# ---------------------------------------------------------------------------
# The TPS loc-net's four convs, the same recipe (the fiducial head, the TPS
# solve and the warp stay float32).
# ---------------------------------------------------------------------------

TPS_CONV_CHANNELS = (64, 128, 256, 512)


def _tps_sites(transformation) -> Folded:
    """BN-folded float32 kernels of the four loc-net convs of a
    ``models.transformation.TPSTransform``."""
    loc = transformation.loc_net
    return {f"conv{ch}": _fold(getattr(loc, f"conv{ch}"), getattr(loc, f"bn{ch}"))
            for ch in TPS_CONV_CHANNELS}


def _tps_locnet_forward(sites: Dict, x: torch.Tensor,
                        record: Optional[Dict[str, float]] = None,
                        act_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The loc-net's conv stack (conv-BN-ReLU x4, 2x2 pools after the first
    three) on [B, H, W, C]; calibration or int8 mode as in :func:`_forward`."""
    x = x.float()
    for ch in TPS_CONV_CHANNELS:
        name, s = f"conv{ch}", sites[f"conv{ch}"]
        if record is not None:
            _record(record, name, x)
            out = _conv_f32(x, *s, (1, 1), (1, 1))
        else:
            hq = torch.clamp(torch.round(div(x.float(), s.x_scale)), -127, 127).to(torch.int8)
            out = dequantize(conv_int8(hq, s, (1, 1), (1, 1)), s.x_scale, s.w_scale,
                             s.bias).to(act_dtype)
        x = torch.relu(out)
        if ch != TPS_CONV_CHANNELS[-1]:
            x = _max_pool(x, (2, 2), (2, 2), (0, 0))
    return x


@torch.no_grad()
def calibrate_tps(transformation, calib_images: torch.Tensor) -> Dict[str, float]:
    """Per-site input abs-max of the loc-net convs over RAW crops [B, H, W,
    1] (the loc-net sees the unrectified image), in full float32."""
    record: Dict[str, float] = {}
    with full_fp32():
        _tps_locnet_forward(_sites_on(_tps_sites(transformation), calib_images.device),
                            calib_images, record=record)
    return record


def quantize_tps(transformation, x_absmax: Dict[str, float]) -> Dict[str, QConv]:
    """PTQ of the TPS loc-net convs, activation scales from ``x_absmax`` (a
    :func:`calibrate_tps` result)."""
    device = transformation.loc_net.fc1.weight.device
    return _quantize_folded(_tps_sites(transformation), x_absmax, device)


@torch.no_grad()
def tps_int8_rectify(transformation, qsites: Dict[str, QConv],
                     images: torch.Tensor) -> torch.Tensor:
    """Rectify [B, H, W, 1] float32 crops with the int8 loc-net convs:
    predict the fiducials (float32 head), solve the TPS grid, warp (the
    port's grid_sample: K2 on the card)."""
    loc = transformation.loc_net
    x = _tps_locnet_forward(qsites, images).float().mean(dim=(1, 2))
    x = torch.relu(loc.fc1(x))
    c_prime = loc.fc2(x).reshape(-1, loc.num_fiducial, 2)
    grid = tps_ops.build_sampling_grid(c_prime, transformation.out_h, transformation.out_w)
    return grid_sample(images.float().contiguous(), grid.contiguous(),
                       plain=not transformation.use_kernels)
