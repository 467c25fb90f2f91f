"""Model assembly: TPS -> ResNet-31 -> semantics -> encoder -> decoder
(JAX counterpart: models/model.py): greedy inference, beam search, and the
teacher-forced training pass."""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.precision import full_fp32
from .decoders import TransformerDecoder
from .encoders import TransformerEncoder
from .layers import BatchNorm2d, dropout, nchw_channels_last
from .resnet import ResNet31, to_column_sequence
from .semantic import LinearEmbedding
from .transformation import TPSTransform


class SceneTextModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if not cfg.decode_fused:
            raise NotImplementedError(
                "the port serves greedy decode through the fused decode kernel "
                "only (decode_fused=True)")
        if cfg.cls_decoder_init:
            raise NotImplementedError("cls_decoder_init is not ported")
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if cfg.use_tps:
            self.transformation = TPSTransform(
                cfg.num_fiducial, cfg.img_h, cfg.img_w, cfg.input_channels, dtype)
        self.feature_extractor = ResNet31(cfg.input_channels, cfg.hidden_dim, dtype=dtype)
        self.semantic = LinearEmbedding(cfg.num_obj_classes, cfg.embed_dim)
        self.encoder = TransformerEncoder(cfg.hidden_dim, cfg.num_heads, cfg.ff_dim,
                                          cfg.enc_layers, cfg.num_cols)
        self.decoder = TransformerDecoder(
            cfg.num_classes, cfg.embed_dim, cfg.hidden_dim, cfg.num_heads, cfg.ff_dim,
            cfg.dec_layers, cfg.max_text_length, dtype,
            early_stop=cfg.decode_early_stop, beam_fused=cfg.decode_beam_fused)
        self.set_use_kernels(True)
        for mod in self.modules():  # cfg.fused_bn is K3's default
            if isinstance(mod, BatchNorm2d):
                mod.use_kernels = cfg.fused_bn

    def set_use_kernels(self, on: bool) -> None:
        """On CUDA tensors, run the hand-written kernels or their plain
        PyTorch versions, which the chip check compares them against: the
        warp (K2), the fused decode with its early stop (K1, K1e), the fused
        beam search (K4) and every BatchNorm's backward reduction (K3).  CPU
        tensors always take the plain versions."""
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

    def decode_from_columns(self, cols: torch.Tensor, overlap: torch.Tensor) -> torch.Tensor:
        """Semantics + encoder + greedy decoder from column features."""
        # the semantic vectors feed only the fusion sites, all off in the
        # served configuration; computed for parity with the JAX forward
        self.semantic(overlap)
        return self.decoder.greedy_decode(self.encoder(cols))

    def forward(self, image: torch.Tensor, overlap: torch.Tensor,
                text: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """image [B, H, W, 1] float32 in [0, 1], overlap [B, n] int ids.

        ``train=False``: greedy logits [B, max_text_length, num_classes]
        float32 (``text`` is ignored).  ``train=True``: the teacher-forced
        pass over ``text`` [B, T] input ids, with BatchNorm on batch
        statistics (updating the running ones) and dropout drawn from
        ``generator`` (on the image's device) -> logits [B, T, num_classes]
        float32."""
        if not train:
            with self.precision():
                return self.decode_from_columns(self.features(self.rectify(image)), overlap)
        if text is None or generator is None:
            raise ValueError("train=True needs the input ids and a generator")
        drop = functools.partial(dropout, p=self.cfg.dropout, generator=generator)
        with self.precision():
            cols = self.features(self.rectify(image, train=True), train=True)
            self.semantic(overlap)  # feeds only the fusion sites, all off
            return self.decoder.teacher_forced(self.encoder(cols, drop), text, drop)

    def beam_decode(self, image: torch.Tensor, overlap: torch.Tensor, beam_size: int = 5,
                    length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search recognition: image [B, H, W, 1] float32 in [0, 1],
        overlap [B, n] ids -> (tokens [B, max_text_length], scores [B]) of
        the best beam per row (see ``TransformerDecoder.beam_decode``)."""
        with self.precision():
            cols = self.features(self.rectify(image))
            self.semantic(overlap)  # feeds only the fusion sites, all off
            return self.decoder.beam_decode(self.encoder(cols), beam_size, length_penalty)


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
