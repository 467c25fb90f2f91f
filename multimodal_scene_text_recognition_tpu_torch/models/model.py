"""Model assembly: TPS -> ResNet-31 -> semantics -> encoder -> decoder
(JAX counterpart: models/model.py): greedy inference, beam search, the
teacher-forced training pass, and the int8 serving step that splices the
int8 loc-net and backbone in front of the encoder and decoder
(:func:`make_int8_eval_step`, JAX models/resnet_int8.make_int8_eval_step).

Every inference entry point takes the semantic inputs of the JAX model:
``overlap`` [B, max_overlap_objs] ids, and as keywords ``scene``
[B, max_scene_objs] ids and ``ious`` [B, max_scene_objs] float32, which
default to the JAX serving defaults (zeros, and -1000 for ``ious``).  The
semantic vectors feed the fusion hooks of the encoder and the decoder, in
serving and in training."""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.precision import full_fp32
from .decoders import SITES, TransformerDecoder
from .encoders import TransformerEncoder
from .layers import BatchNorm2d, dropout, nchw_channels_last
from .resnet import ResNet31, to_column_sequence
from .resnet_int8 import QConv, quantize_resnet, quantize_tps, resnet31_int8_forward, \
    tps_int8_rectify
from .semantic import build_semantic_embedder
from .transformation import TPSTransform


class SceneTextModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.label_codec != "attn":
            raise NotImplementedError(f"label_codec={cfg.label_codec!r}: the CTC codec and "
                                      "its linear decoder are not ported yet")
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if cfg.use_tps:
            self.transformation = TPSTransform(
                cfg.num_fiducial, cfg.img_h, cfg.img_w, cfg.input_channels, dtype)
        self.feature_extractor = ResNet31(cfg.input_channels, cfg.hidden_dim, dtype=dtype)
        self.semantic = build_semantic_embedder(cfg)
        self.encoder = TransformerEncoder(cfg.hidden_dim, cfg.num_heads, cfg.ff_dim,
                                          cfg.enc_layers, cfg.num_cols, int8=cfg.encoder_int8,
                                          pre_encoder_mlp=cfg.pre_encoder_mlp,
                                          embed_dim=cfg.embed_dim)
        self.decoder = TransformerDecoder(
            cfg.num_classes, cfg.embed_dim, cfg.hidden_dim, cfg.num_heads, cfg.ff_dim,
            cfg.dec_layers, cfg.max_text_length, dtype,
            early_stop=cfg.decode_early_stop, beam_fused=cfg.decode_beam_fused,
            int8=cfg.decode_int8, pre_decoder_mlp=cfg.pre_decoder_mlp,
            cls_decoder_init=cfg.cls_decoder_init, post_decoder_mlp=cfg.post_decoder_mlp,
            fused=cfg.decode_fused,
            sites=[s for s in SITES if getattr(cfg, f"multihead_{s}")])
        self.set_use_kernels(True)
        for mod in self.modules():  # cfg.fused_bn is K3's default
            if isinstance(mod, BatchNorm2d):
                mod.use_kernels = cfg.fused_bn

    def set_use_kernels(self, on: bool) -> None:
        """On CUDA tensors, run the hand-written kernels or their plain
        PyTorch versions, which the chip check compares them against: the
        warp (K2), the fused decode with its early stop and its int8 mode
        (K1, K1e, K1q), the fused beam search (K4) and every BatchNorm's
        backward reduction (K3).  CPU tensors always take the plain
        versions."""
        if self.cfg.use_tps:
            self.transformation.use_kernels = on
        self.decoder.use_kernels = on
        for mod in self.modules():
            if isinstance(mod, BatchNorm2d):
                mod.use_kernels = on

    def precision(self):
        """The context the model's forward and backward run in: full float32
        (TF32 off for matmuls and convs, whatever the caller set) where the
        compute type is float32; the caller's settings otherwise."""
        if self.cfg.compute_dtype == "float32":
            return full_fp32()
        return contextlib.nullcontext()

    def rectify(self, image: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, H, W, 1] float32 -> rectified [B, H, W, 1] float32 (the crop
        itself when ``use_tps`` is off)."""
        return self.transformation(image, train) if self.cfg.use_tps else image

    def features(self, rectified: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Backbone: [B, H, W, 1] -> column features [B, W', hidden] f32."""
        feats = self.feature_extractor(nchw_channels_last(rectified), train)
        return to_column_sequence(feats)

    def semantics(self, overlap: torch.Tensor, scene: Optional[torch.Tensor] = None,
                  ious: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The semantic vectors [B, O, embed_dim] float32 of the object ids;
        ``scene`` and ``ious`` default to zeros and -1000 (the JAX serving
        defaults: no scene objects)."""
        B, n = overlap.shape[0], self.cfg.max_scene_objs
        if scene is None:
            scene = torch.zeros(B, n, dtype=torch.long, device=overlap.device)
        if ious is None:
            ious = torch.full((B, n), -1000.0, device=overlap.device)
        return self.semantic(overlap, scene, ious)

    def decode_from_columns(self, cols: torch.Tensor, overlap: torch.Tensor, *,
                            scene: Optional[torch.Tensor] = None,
                            ious: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Semantics + encoder + greedy decoder from column features."""
        sem = self.semantics(overlap, scene, ious)
        return self.decoder.greedy_decode(self.encoder(cols, semantics=sem), sem)

    def beam_from_columns(self, cols: torch.Tensor, overlap: torch.Tensor, *,
                          scene: Optional[torch.Tensor] = None,
                          ious: Optional[torch.Tensor] = None, beam_size: int = 5,
                          length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Semantics + encoder + beam search from column features: the
        :meth:`decode_from_columns` counterpart for spliced backbones (int8
        serving) -> (tokens [B, max_text_length], scores [B])."""
        sem = self.semantics(overlap, scene, ious)
        return self.decoder.beam_decode(self.encoder(cols, semantics=sem), sem, beam_size,
                                        length_penalty)

    def forward(self, image: torch.Tensor, overlap: torch.Tensor,
                text: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None, *,
                scene: Optional[torch.Tensor] = None,
                ious: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image [B, H, W, 1] float32 in [0, 1], overlap [B, n] int ids
        (``scene``/``ious``: see the module's docstring).

        ``train=False``: greedy logits [B, max_text_length, num_classes]
        float32 (``text`` is ignored).  ``train=True``: the teacher-forced
        pass over ``text`` [B, T] input ids, with BatchNorm on batch
        statistics (updating the running ones), dropout drawn from
        ``generator`` (on the image's device) and the semantic vectors
        through every fusion hook that is on -> logits [B, T, num_classes]
        float32."""
        if not train:
            with self.precision():
                return self.decode_from_columns(self.features(self.rectify(image)), overlap,
                                                scene=scene, ious=ious)
        if text is None or generator is None:
            raise ValueError("train=True needs the input ids and a generator")
        drop = functools.partial(dropout, p=self.cfg.dropout, generator=generator)
        with self.precision():
            cols = self.features(self.rectify(image, train=True), train=True)
            sem = self.semantics(overlap, scene, ious)
            enc = self.encoder(cols, drop, train=True, semantics=sem)
            return self.decoder.teacher_forced(enc, text, drop, sem)

    def beam_decode(self, image: torch.Tensor, overlap: torch.Tensor, beam_size: int = 5,
                    length_penalty: float = 0.0, *, scene: Optional[torch.Tensor] = None,
                    ious: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search recognition: image [B, H, W, 1] float32 in [0, 1],
        overlap [B, n] ids (``scene``/``ious``: see the module's docstring)
        -> (tokens [B, max_text_length], scores [B]) of the best beam per
        row (see ``TransformerDecoder.beam_decode``)."""
        with self.precision():
            return self.beam_from_columns(self.features(self.rectify(image)), overlap,
                                          scene=scene, ious=ious, beam_size=beam_size,
                                          length_penalty=length_penalty)


def make_int8_eval_step(model: SceneTextModel, x_absmax: Dict[str, float],
                        beam_size: Optional[int] = None
                        ) -> Tuple[Callable, Dict[str, QConv]]:
    """The int8 serving step of ``model`` (in eval mode): TPS (the int8
    loc-net when ``cfg.tps_int8`` and ``cfg.use_tps``, else the model's
    own) -> int8 ResNet-31 -> columns -> the model's encoder and decoder
    (themselves int8 where ``encoder_int8`` / ``decode_int8`` say).

    Activation scales come from ``x_absmax``, a calibration (the
    Recognizer's, or a persisted one) with the loc-net's sites under a
    ``tps/`` prefix.  Returns ``(step, qsites)``: ``step(image, overlap,
    scene=None, ious=None)`` -> ids [B, T], or with ``beam_size`` (ids
    [B, T], scores [B]) by beam search over the same spliced pipeline; ``step.rectify(image)`` and
    ``step.features(rectified)`` -> columns are its first two stages;
    ``qsites`` the quantized sites (loc-net ones under ``tps/``)."""
    cfg = model.cfg
    tps8 = cfg.tps_int8 and cfg.use_tps
    rn_absmax = {k: v for k, v in x_absmax.items() if not k.startswith("tps/")}
    tps_absmax = {k[len("tps/"):]: v for k, v in x_absmax.items() if k.startswith("tps/")}
    if tps8 and not tps_absmax:
        raise ValueError(
            "tps_int8 needs TPS activation scales: the persisted npz has no tps/ keys "
            "(calibrate with tps_int8 set, e.g. Recognizer.calibrate_int8)")
    rq = quantize_resnet(model.feature_extractor, rn_absmax)
    tq = quantize_tps(model.transformation, tps_absmax) if tps8 else {}
    qsites = {**rq, **{f"tps/{k}": v for k, v in tq.items()}}

    @torch.no_grad()
    def rectify(image: torch.Tensor) -> torch.Tensor:
        with model.precision():
            return (tps_int8_rectify(model.transformation, tq, image) if tps8
                    else model.rectify(image))

    @torch.no_grad()
    def features(rectified: torch.Tensor) -> torch.Tensor:
        with model.precision():
            feats = resnet31_int8_forward(rq, rectified, cfg.hidden_dim)
            return to_column_sequence(feats.permute(0, 3, 1, 2))

    @torch.no_grad()
    def step(image: torch.Tensor, overlap: torch.Tensor, scene: Optional[torch.Tensor] = None,
             ious: Optional[torch.Tensor] = None):
        with model.precision():
            cols = features(rectify(image))
            if beam_size is not None:
                return model.beam_from_columns(cols, overlap, scene=scene, ious=ious,
                                               beam_size=beam_size)
            return model.decode_from_columns(cols, overlap, scene=scene,
                                             ious=ious).argmax(dim=-1)

    step.rectify, step.features = rectify, features
    return step, qsites


@torch.no_grad()
def init_random(model: SceneTextModel, generator: torch.Generator) -> None:
    """Fill every parameter and statistic from ``generator``: matrices and
    conv kernels ~ N(0, 1/fan_in), embedding tables ~ N(0, 1), norms at
    identity, other biases zero, the fiducial head at the identity warp."""
    norm_params = set()
    for mod in model.modules():
        if isinstance(mod, (nn.LayerNorm, BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            norm_params |= {id(mod.weight), id(mod.bias)}
        if isinstance(mod, BatchNorm2d):
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
        if isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator))
            norm_params.add(id(mod.weight))
    for p in model.parameters():
        if id(p) in norm_params:
            continue
        if p.dim() >= 2:
            std = 1.0 / math.sqrt(p[0].numel())
            p.copy_(torch.randn(p.shape, generator=generator) * std)
        else:
            p.zero_()
    if model.cfg.use_tps:
        model.transformation.loc_net.init_identity_head()
