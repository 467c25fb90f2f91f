"""Reference ``.pth`` import: the reference PyTorch codebase's state dict
onto the port's model (JAX counterpart: train/torch_import.py, whose key
map this module copies).

The reference's keys carry nn.DataParallel's ``module.`` prefix and name
its own modules; its loader skips the semantic embed table
(``get_semantic_vectors.embed.weight``) and tolerates unmatched keys
(strict=False).  The map is keyed by the JAX package's tree (collection,
module path, leaf), which the port's ``state_dict`` reaches through the
weight bridge (``convert.state_dict_to_bundle``), so the same map serves
both packages:

  torch Conv2d  OIHW [out,in,kh,kw] -> HWIO [kh,kw,in,out]
  torch Linear  [out,in]            -> kernel [in,out]
  torch LSTM    weight_*  [4H, d]   -> [d, 4H]   (gate order i,f,g,o kept)
  torch MHA     in_proj [3E, E]     -> w_qkv [E, 3E]
  BertSelfAttention query/key/value -> one packed w_qkv / b_qkv
  BatchNorm     weight/bias -> scale/bias; running_mean/var -> mean/var

Torch-side names mirror the reference modules: the TPS localization
network (``Transformation.LocalizationNetwork.*``), the ResNet
(``FeatureExtraction.ConvNet.*``), the BiLSTM and transformer encoders
(``encoder.{0,1}.*``, ``encoder.encoder.*``), the Oscar encoder's BertModel
(``encoder.bert_model.*``), the decoders (``decoder.*``,
``decoder.decoder.layers.*``) with every fusion MLP and the three layer
sites, and the semantic embedders (``get_semantic_vectors.*``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import convert


def _t_linear(w):  # torch Linear weight -> Dense kernel
    return np.asarray(w).T


def _t_conv(w):  # OIHW -> HWIO
    return np.asarray(w).transpose(2, 3, 1, 0)


def _ident(w):
    return np.asarray(w)


def _t_qkv_w(ws):  # 3 torch [E,E] q/k/v weights -> packed w_qkv [E, 3E]
    return np.concatenate([np.asarray(w).T for w in ws], axis=1)


def _t_qkv_b(bs):  # 3 torch [E] q/k/v biases -> packed b_qkv [3E]
    return np.concatenate([np.asarray(b) for b in bs])


# ---------------------------------------------------------------------------
# JAX tree path -> (torch key suffix, transform)
# ---------------------------------------------------------------------------

_LOC_CONV = {"conv64": 0, "conv128": 4, "conv256": 8, "conv512": 12}
_LOC_BN = {"bn64": 1, "bn128": 5, "bn256": 9, "bn512": 13}

_RESNET_STAGE = {"1": "layer1", "2": "layer2", "3": "layer3", "4": "layer4"}
_RESNET_TRANS = {
    "trans1": ("conv1", "bn1"),
    "trans2": ("conv2", "bn2"),
    "trans3": ("conv3", "bn3"),
    "trans4a": ("conv4_1", "bn4_1"),
    "trans4b": ("conv4_2", "bn4_2"),
}


def _bn_leaf(collection: str, leaf: str) -> Optional[str]:
    """BatchNorm leaf -> torch suffix."""
    if collection == "params":
        return {"scale": "weight", "bias": "bias"}.get(leaf)
    return {"mean": "running_mean", "var": "running_var"}.get(leaf)


def _mha_keys(torch_prefix: str, leaf: str):
    return {
        "w_qkv": (f"{torch_prefix}.in_proj_weight", _t_linear),
        "b_qkv": (f"{torch_prefix}.in_proj_bias", _ident),
        "w_out": (f"{torch_prefix}.out_proj.weight", _t_linear),
        "b_out": (f"{torch_prefix}.out_proj.bias", _ident),
    }.get(leaf)


def _lstm_keys(torch_prefix: str, leaf: str, reverse: bool = False):
    sfx = "_reverse" if reverse else ""
    return {
        "w_ih": (f"{torch_prefix}.weight_ih_l0{sfx}", _t_linear),
        "w_hh": (f"{torch_prefix}.weight_hh_l0{sfx}", _t_linear),
        "b_ih": (f"{torch_prefix}.bias_ih_l0{sfx}", _ident),
        "b_hh": (f"{torch_prefix}.bias_hh_l0{sfx}", _ident),
    }.get(leaf)


def _linear_leaf(torch_prefix: str, leaf: str):
    """kernel/bias leaf of a Linear-shaped module."""
    return (f"{torch_prefix}.{'weight' if leaf == 'kernel' else 'bias'}",
            _t_linear if leaf == "kernel" else _ident)


def _norm_leaf(torch_prefix: str, leaf: str):
    """scale/bias leaf of a LayerNorm."""
    return f"{torch_prefix}.{'weight' if leaf == 'scale' else 'bias'}", _ident


def _mlpp_keys(torch_prefix: str, leaf: str):
    """A flat MLPP leaf ``fc{i}_kernel|fc{i}_bias`` -> the reference MLP key
    ``<prefix>.layers.fc{i}.weight|bias`` (an nn.Sequential of named fc
    layers)."""
    m = re.match(r"fc(\d+)_(kernel|bias)", leaf)
    if not m:
        return None
    i, kind = m.groups()
    return _linear_leaf(f"{torch_prefix}.layers.fc{i}", kind)


def _mlp_keys(torch_prefix: str, sub: str, leaf: str):
    """Nested MLP module path ``fc{i}/kernel|bias`` -> reference MLP key."""
    m = re.match(r"fc(\d+)", sub)
    if not m or leaf not in ("kernel", "bias"):
        return None
    return _linear_leaf(f"{torch_prefix}.layers.fc{m.group(1)}", leaf)


# the decoder-level MLPP name -> the reference attribute (with the
# reference's ``post_deocer_combine_mlp`` spelling)
_DEC_MLPS = {
    "relevant_mlp": "relevant_mlp",
    "combine_mlp": "combine_mlp",
    "sem_cls_mlp": "sem_cls_mlp",
    "post_mlp": "post_decoder_mlp",
    "post_combine_mlp": "post_deocer_combine_mlp",
}

# the in-layer fusion-site suffixes
_LAYER_SITES = ("pre_target", "pre_memory", "post_memory")


def _loc_net_key(collection: str, name: str, leaf: str):
    base = "Transformation.LocalizationNetwork"
    if name in _LOC_CONV and leaf == "kernel":
        return f"{base}.conv.{_LOC_CONV[name]}.weight", _t_conv
    if name in _LOC_BN:
        tl = _bn_leaf(collection, leaf)
        if tl:
            return f"{base}.conv.{_LOC_BN[name]}.{tl}", _ident
    if name == "fc1":
        return _linear_leaf(f"{base}.localization_fc1.0", leaf)
    if name == "fc2":
        return _linear_leaf(f"{base}.localization_fc2", leaf)
    return None


def _resnet_key(collection: str, p, leaf: str):
    base = "FeatureExtraction.ConvNet"
    name = p[1]
    m = re.match(r"stem(\d)_(conv|bn)", name)
    if m:
        i, kind = m.groups()
        tn = f"conv0_{int(i) + 1}" if kind == "conv" else f"bn0_{int(i) + 1}"
        if kind == "conv" and leaf == "kernel":
            return f"{base}.{tn}.weight", _t_conv
        tl = _bn_leaf(collection, leaf)
        if kind == "bn" and tl:
            return f"{base}.{tn}.{tl}", _ident
        return None
    m = re.match(r"block(\d)_(\d+)", name)
    if m:
        stage, bi = m.groups()
        tbase = f"{base}.{_RESNET_STAGE[stage]}.{bi}"
        inner = p[2]
        if inner in ("conv1", "conv2") and leaf == "kernel":
            return f"{tbase}.{inner}.weight", _t_conv
        if inner in ("bn1", "bn2"):
            tl = _bn_leaf(collection, leaf)
            if tl:
                return f"{tbase}.{inner}.{tl}", _ident
        if inner == "downsample_conv" and leaf == "kernel":
            return f"{tbase}.downsample.0.weight", _t_conv
        if inner == "downsample_bn":
            tl = _bn_leaf(collection, leaf)
            if tl:
                return f"{tbase}.downsample.1.{tl}", _ident
        return None
    m = re.match(r"(trans\w+)_(conv|bn)", name)
    if m:
        t, kind = m.groups()
        conv_n, bn_n = _RESNET_TRANS[t]
        if kind == "conv" and leaf == "kernel":
            return f"{base}.{conv_n}.weight", _t_conv
        tl = _bn_leaf(collection, leaf)
        if kind == "bn" and tl:
            return f"{base}.{bn_n}.{tl}", _ident
    return None


def _semantic_key(p, leaf: str):
    if p[1] == "embed" and leaf == "embedding":
        return "get_semantic_vectors.embed.weight", _ident
    if p[1] in ("overlap_embed", "scene_embed") and leaf == "embedding":
        return f"get_semantic_vectors.{p[1]}.weight", _ident
    if p[1] == "combine":
        return _linear_leaf("get_semantic_vectors.combine", leaf)
    # the DistilBERT embedder: the reference wraps a transformers
    # DistilBertModel as ``bert_model``, whose layout the embedder mirrors
    bert = "get_semantic_vectors.bert_model"
    if p[1] == "tok" and leaf == "embedding":
        return f"{bert}.embeddings.word_embeddings.weight", _ident
    if p[1] == "pos" and leaf == "embedding":
        return f"{bert}.embeddings.position_embeddings.weight", _ident
    if p[1] == "embed_ln":
        return _norm_leaf(f"{bert}.embeddings.LayerNorm", leaf)
    m = re.match(r"(q_lin|k_lin|v_lin|out_lin)(\d+)", p[1])
    if m:
        name, i = m.groups()
        return _linear_leaf(f"{bert}.transformer.layer.{i}.attention.{name}", leaf)
    m = re.match(r"sa_ln(\d+)", p[1])
    if m:
        return _norm_leaf(f"{bert}.transformer.layer.{m.group(1)}.sa_layer_norm", leaf)
    m = re.match(r"ff(1|2)_(\d+)", p[1])
    if m:
        j, i = m.groups()
        return _linear_leaf(f"{bert}.transformer.layer.{i}.ffn.lin{j}", leaf)
    m = re.match(r"out_ln(\d+)", p[1])
    if m:
        return _norm_leaf(f"{bert}.transformer.layer.{m.group(1)}.output_layer_norm", leaf)
    # ``proj`` (768 -> embed_dim) has no reference key
    return None


def _encoder_key(p, leaf: str):
    # the Oscar encoder: the reference wraps a transformers BertModel as
    # ``bert_model`` between the hid_to_bert / bert_to_hid Linears; the
    # packed w_qkv takes BertSelfAttention's three Linears
    obert = "encoder.bert_model"
    if p[1] in ("hid_to_bert", "bert_to_hid"):
        return _linear_leaf(f"encoder.{p[1]}", leaf)
    if p[1] == "pos_embed" and leaf == "embedding":
        return f"{obert}.embeddings.position_embeddings.weight", _ident
    if p[1] == "seg_embed" and leaf == "embedding":
        return f"{obert}.embeddings.token_type_embeddings.weight", _ident
    if p[1] == "embed_ln":
        return _norm_leaf(f"{obert}.embeddings.LayerNorm", leaf)
    m = re.match(r"attn(\d+)", p[1]) if len(p) > 1 else None
    if m:
        att = f"{obert}.encoder.layer.{m.group(1)}.attention"
        if leaf == "w_qkv":
            return tuple(f"{att}.self.{n}.weight" for n in ("query", "key", "value")), _t_qkv_w
        if leaf == "b_qkv":
            return tuple(f"{att}.self.{n}.bias" for n in ("query", "key", "value")), _t_qkv_b
        if leaf == "w_out":
            return f"{att}.output.dense.weight", _t_linear
        if leaf == "b_out":
            return f"{att}.output.dense.bias", _ident
        return None
    m = re.match(r"ln([12])_(\d+)", p[1]) if len(p) > 1 else None
    if m:
        j, i = m.groups()
        tn = (f"{obert}.encoder.layer.{i}.attention.output.LayerNorm" if j == "1"
              else f"{obert}.encoder.layer.{i}.output.LayerNorm")
        return _norm_leaf(tn, leaf)
    m = re.match(r"ff([12])_(\d+)", p[1]) if len(p) > 1 else None
    if m:
        j, i = m.groups()
        tn = (f"{obert}.encoder.layer.{i}.intermediate.dense" if j == "1"
              else f"{obert}.encoder.layer.{i}.output.dense")
        return _linear_leaf(tn, leaf)
    # ``sem_to_bert`` has no reference key: the reference's fused Oscar
    # input cannot run, so it has no weights to import

    # the BiLSTM stack: encoder.l{i}.{fwd,bwd,proj}
    m = re.match(r"l(\d)", p[1]) if len(p) > 1 else None
    if m:
        i = m.group(1)
        if p[2] in ("fwd", "bwd"):
            return _lstm_keys(f"encoder.{i}.rnn", leaf, reverse=(p[2] == "bwd"))
        if p[2] == "proj":
            return _linear_leaf(f"encoder.{i}.linear", leaf)
        return None
    # the transformer encoder
    m = re.match(r"layer(\d+)", p[1]) if len(p) > 1 else None
    if m:
        tbase = f"encoder.encoder.layers.{m.group(1)}"
        inner = p[2]
        if inner == "self_attn":
            return _mha_keys(f"{tbase}.self_attn", leaf)
        if inner in ("linear1", "linear2"):
            return _linear_leaf(f"{tbase}.{inner}", leaf)
        if inner in ("norm1", "norm2"):
            return _norm_leaf(f"{tbase}.{inner}", leaf)
        return None
    if p[1] == "final_norm":
        return _norm_leaf("encoder.encoder.norm", leaf)
    # the pre-encoder fusion MLPs (the reference spells ``sem_relevence_mlp``)
    if p[1] == "sem_relevance_mlp" and len(p) == 4:
        return _mlp_keys("encoder.sem_relevence_mlp", p[2], leaf)
    if p[1] == "combine_mlp" and len(p) == 4:
        return _mlp_keys("encoder.combine_mlp", p[2], leaf)
    return None


def _decoder_key(p, leaf: str):
    m = re.match(r"layer(\d+)", p[1]) if len(p) > 1 else None
    if m:
        tbase = f"decoder.decoder.layers.{m.group(1)}"
        inner = p[2]
        if inner == "self_attn":
            return _mha_keys(f"{tbase}.self_attn", leaf)
        if inner == "cross_attn":
            return _mha_keys(f"{tbase}.multihead_attn", leaf)
        if inner in ("linear1", "linear2"):
            return _linear_leaf(f"{tbase}.{inner}", leaf)
        if inner in ("norm1", "norm2", "norm3"):
            return _norm_leaf(f"{tbase}.{inner}", leaf)
        # the in-layer fusion sites: mha_{site} <-> multihead_{site},
        # mlp_{site} <-> relevant_mlp_{site}
        for site in _LAYER_SITES:
            if inner == f"mha_{site}":
                return _mha_keys(f"{tbase}.multihead_{site}", leaf)
            if inner == f"mlp_{site}":
                return _mlpp_keys(f"{tbase}.relevant_mlp_{site}", leaf)
        return None
    # the decoder-level fusion MLPs
    if p[1] in _DEC_MLPS and len(p) == 3:
        return _mlpp_keys(f"decoder.{_DEC_MLPS[p[1]]}", leaf)
    if p[1] in ("sem_to_classes", "hid_to_emb", "emb_to_classes", "generator"):
        return _linear_leaf(f"decoder.{p[1]}", leaf)
    if p[1] == "final_norm":
        return _norm_leaf("decoder.decoder.norm", leaf)
    if p[1] == "emb" and leaf == "embedding":
        return "decoder.emb.weight", _ident
    # the LSTM-attention decoder
    if p[1] in ("i2h", "h2h", "score"):
        return _linear_leaf(f"decoder.attention_cell.{p[1]}", leaf)
    if p[1] in ("w_ih", "w_hh", "b_ih", "b_hh"):
        tname = f"weight_{p[1][2:]}" if p[1].startswith("w") else f"bias_{p[1][2:]}"
        return (f"decoder.attention_cell.rnn.{tname}",
                _t_linear if p[1].startswith("w") else _ident)
    # the linear decoder
    if p[1] == "head":
        return _linear_leaf("decoder.linear_decoder", leaf)
    return None


def torch_key_for(collection: str, path: Tuple[str, ...]):
    """(collection, JAX tree path) -> (torch key or tuple of keys,
    transform), or None where the reference has no counterpart."""
    p = list(path)
    leaf = p[-1]
    if p[:2] == ["transformation", "loc_net"]:
        return _loc_net_key(collection, p[2], leaf)
    if p[0] == "feature_extractor":
        return _resnet_key(collection, p, leaf)
    if p[0] == "semantic":
        return _semantic_key(p, leaf)
    if p[0] == "encoder":
        return _encoder_key(p, leaf)
    if p[0] == "decoder":
        return _decoder_key(p, leaf)
    return None


def _ignored(key: str) -> bool:
    """Reference keys with no counterpart that an import does not report:
    BatchNorm counters, sinusoid tables, the TPS grid generator's
    constants, clone prototypes and duplicate norms, modules the reference
    declares and never runs, and the Oscar BertModel's unused word
    embeddings, pooler and position-id buffer."""
    return (key.endswith("num_batches_tracked")
            or ".pos_encoder." in key
            or key.startswith("Transformation.GridGenerator")
            or ".semantic_to_emb." in key
            or key.startswith(("decoder.decoder_layer.", "encoder.encoder_layer.",
                               "encoder.layer_norm.", "decoder.layer_norm.",
                               "encoder.emb_to_hid",
                               "encoder.bert_model.embeddings.word_embeddings",
                               "encoder.bert_model.pooler."))
            or re.search(r"\.norm_(pre_target|pre_memory|post_memory)\.", key) is not None
            or key == "encoder.bert_model.embeddings.position_ids")


def _to_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def convert_state_dict(sd: Mapping[str, Any], model: torch.nn.Module,
                       skip_semantic_embed: bool = True,
                       strict: bool = False) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``model``'s ``state_dict`` (float32, on the CPU) with every entry the
    reference state dict ``sd`` holds replaced by it, and the stats
    ``{loaded, missing, skipped, unused_torch_keys}`` as the JAX package
    counts them: ``loaded`` the number of entries filled, ``missing`` the
    JAX paths (``params/decoder/...``) that ``sd`` or the map lacks,
    ``skipped`` the semantic embed table where ``skip_semantic_embed``, and
    ``unused_torch_keys`` the keys of ``sd`` (without ``module.``) that
    filled nothing and are not ignored.  A shape mismatch raises
    ValueError; with ``strict`` a key the map names and ``sd`` lacks raises
    KeyError.  The model is not changed."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    flat = convert.state_dict_to_bundle(model.state_dict())
    # JAX walks its trees in sorted key order, params before batch_stats
    entries = sorted((("params", "batch_stats").index(k.split(".", 1)[0]),
                      tuple(k.split(".")[1:]), k) for k in flat)
    loaded, missing, skipped = [], [], []
    used = set()
    for _, path, key in entries:
        collection = key.split(".", 1)[0]
        km = torch_key_for(collection, path)
        if km is None:
            missing.append("/".join((collection,) + path))
            continue
        tkey, transform = km
        if skip_semantic_embed and tkey == "get_semantic_vectors.embed.weight":
            skipped.append(tkey)
            continue
        keys = tkey if isinstance(tkey, tuple) else (tkey,)
        if any(k not in sd for k in keys):
            missing.append("/".join((collection,) + path))
            if strict:
                raise KeyError(f"torch key(s) {keys} not found")
            continue
        new = transform([_to_np(sd[k]) for k in keys] if isinstance(tkey, tuple)
                        else _to_np(sd[tkey]))
        old = flat[key]
        if tuple(new.shape) != tuple(old.shape):
            raise ValueError(f"shape mismatch {tkey} -> {'/'.join(path)}: "
                             f"{new.shape} vs {old.shape}")
        flat[key] = new.astype(old.dtype)
        loaded.append(tkey)
        used.update(keys)
    unused = [k for k in sd if k not in used and not _ignored(k)]
    stats = {"loaded": len(loaded), "missing": missing, "skipped": skipped,
             "unused_torch_keys": unused}
    return convert.bundle_to_state_dict(flat), stats
