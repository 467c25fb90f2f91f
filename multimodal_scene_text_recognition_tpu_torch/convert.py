"""Weight bridge: the JAX package's flat parameter bundle <-> the port's
``state_dict``.

A bundle (``train/checkpoint.save_params_bundle`` in the JAX package, e.g.
``assets/trained/synth_openvocab_xxl.params.npz``) maps dotted keys
``params.<module path>.<leaf>`` and ``batch_stats.<module path>.<leaf>`` to
arrays (fp16 on disk), plus the scalar ``__step__``.  The port's modules use
the same module paths, so only the leaf name and the layout change:

    kernel [kh, kw, in, out] (conv, HWIO)  -> weight [out, in, kh, kw]
    kernel [in, out] (dense)               -> weight [out, in]
    scale (layernorm / batchnorm)          -> weight
    embedding [n, E]                       -> weight
    w_qkv [E, 3E] / b_qkv                  -> in_proj_weight [3E, E] / in_proj_bias
    w_out [E, E] / b_out                   -> out_proj.weight [E, E] / out_proj.bias
    batch_stats mean / var                 -> running_mean / running_var
    fc{i}_kernel [in, out] / fc{i}_bias    -> fc{i}.weight [out, in] / fc{i}.bias
    w_ih [I, 4H] / w_hh [H, 4H]            -> w_ih [4H, I] / w_hh [4H, H]
    b_ih / b_hh [4H]                       -> b_ih / b_hh
    <fwd|bwd>.w_ih / w_hh / b_ih / b_hh    -> <fwd|bwd>.weight_ih_l0 [4H, I] /
                                              weight_hh_l0 [4H, H] / bias_ih_l0 /
                                              bias_hh_l0

The last row is the JAX package's ``MLPP``, whose layers are flat leaves of
one module: the decoder's fusion MLPs (``relevant_mlp``, ``combine_mlp``,
``sem_cls_mlp``, ``post_mlp``, ``post_combine_mlp``) and each layer's
fusion-site MLPs (``layer<i>.mlp_<site>``, beside its attention
``layer<i>.mha_<site>``).  Its ``MLP`` (the
encoder's ``sem_relevance_mlp`` and ``combine_mlp``) keeps one module per
layer, ``fc{i}.kernel``, as any dense layer.

The LSTM rows: the LSTM-attention decoder keeps its cell's four leaves on
itself, under JAX's names; each direction of a BiLSTM block
(``encoder.l<i>.fwd`` and ``.bwd``) is an ``nn.LSTM``, which names them as
torch does.  Both biases map as they are (gates i, f, g, o in both
packages); the decoder's ``i2h``, ``h2h``, ``score`` and ``generator``, a
block's ``proj`` and the linear decoder's ``head`` are dense layers.

The Oscar encoder's attentions (``encoder.attn<i>``) are packed
(``w_qkv``) and its other layers dense; the BERT embedder's ``q_lin<i>``,
``k_lin<i>``, ``v_lin<i>``, ``out_lin<i>`` and FF layers are dense.  A
model built with ``remat`` has the same tree.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {
    "bias": "bias",
    "scale": "weight",
    "embedding": "weight",
    "kernel": "weight",
    "w_qkv": "in_proj_weight",
    "b_qkv": "in_proj_bias",
    "w_out": "out_proj.weight",
    "b_out": "out_proj.bias",
    "mean": "running_mean",
    "var": "running_var",
}
_LEAF.update({k: k for k in ("w_ih", "w_hh", "b_ih", "b_hh")})  # the LSTM decoder's cell
# the same leaves in an nn.LSTM (a BiLSTM block's fwd and bwd)
_LSTM_LEAF = {"w_ih": "weight_ih_l0", "w_hh": "weight_hh_l0", "b_ih": "bias_ih_l0",
              "b_hh": "bias_hh_l0"}
_LSTM_MODULES = ("fwd", "bwd")
_TRANSPOSED = {"kernel", "w_qkv", "w_out", "w_ih", "w_hh"}
# the embedding tables: the decoder's, the linear embedders', the BERT
# embedder's token and position tables, the Oscar encoder's position and
# segment tables
_EMBEDDINGS = ("emb", "embed", "overlap_embed", "scene_embed", "tok", "pos", "pos_embed",
               "seg_embed")
META_KEYS = ("__step__",)
_FLAT_LAYER = re.compile(r"(fc\d+)_(kernel|bias)")  # an MLPP leaf
_FLAT_MLP = re.compile(r"decoder\.(\w+_mlp|layer\d+\.mlp_\w+)\.fc\d+")  # a port layer of an MLPP


def _convert(leaf: str, arr: np.ndarray) -> np.ndarray:
    arr = np.array(arr, np.float32)  # a writable float32 copy
    if leaf in _TRANSPOSED:
        if arr.ndim == 4:  # HWIO -> OIHW
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:  # [in, out] -> [out, in]
            return arr.T
        raise ValueError(f"unexpected {leaf} of shape {arr.shape}")
    return arr


def bundle_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Convert a flat ``{dotted key: array}`` bundle to a float32
    ``state_dict``.  Every key except ``__step__`` maps to exactly one
    entry; an unknown leaf, or two keys landing on one entry, raises."""
    out: Dict[str, torch.Tensor] = {}
    for key in flat:
        if key in META_KEYS:
            continue
        collection, _, rest = key.partition(".")
        path, _, leaf = rest.rpartition(".")
        layer = _FLAT_LAYER.fullmatch(leaf)
        if layer:
            path = f"{path}.{layer.group(1)}" if path else layer.group(1)
            leaf = layer.group(2)
        ok = (collection == "params" and leaf in _LEAF and leaf not in ("mean", "var")) or (
            collection == "batch_stats" and leaf in ("mean", "var"))
        if not ok or not path:
            raise KeyError(f"bundle key {key!r} has no counterpart in the port")
        port_leaf = _LEAF[leaf]
        if leaf in _LSTM_LEAF and path.rsplit(".", 1)[-1] in _LSTM_MODULES:
            port_leaf = _LSTM_LEAF[leaf]
        name = f"{path}.{port_leaf}"
        if name in out:
            raise KeyError(f"bundle keys collide on {name!r}")
        out[name] = torch.from_numpy(np.ascontiguousarray(_convert(leaf, flat[key])))
    return out


def load_bundle(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.params.npz`` bundle with numpy alone."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}



def _bundle_leaf(path: str, leaf: str, t: torch.Tensor) -> str:
    """The JAX leaf name of the port entry ``<path>.<leaf>``.  ``weight``
    is ambiguous: a norm's scale (one dimension), an embedding table (the
    modules named in ``_EMBEDDINGS``, as in the JAX tree) or a kernel."""
    lstm = {v: k for k, v in _LSTM_LEAF.items()}
    if leaf in lstm:
        return lstm[leaf]
    if leaf != "weight":
        return next(k for k, v in _LEAF.items() if v == leaf)
    if t.dim() == 1:
        return "scale"
    return "embedding" if path.rsplit(".", 1)[-1] in _EMBEDDINGS else "kernel"


def bundle_key(name: str, t: torch.Tensor) -> Tuple[str, bool]:
    """The bundle key of the port ``state_dict`` entry ``name`` (holding
    ``t``, read for its rank alone), and whether the JAX leaf is the port
    tensor transposed.  An entry with no counterpart raises."""
    port_leaves = sorted(set(_LEAF.values()) | set(_LSTM_LEAF.values()), key=len, reverse=True)
    leaf = next((k for k in port_leaves if name.endswith("." + k)), None)
    if leaf is None:
        raise KeyError(f"state_dict entry {name!r} has no counterpart in a bundle")
    path = name[: -len(leaf) - 1]
    jleaf = _bundle_leaf(path, leaf, t)
    collection = "batch_stats" if jleaf in ("mean", "var") else "params"
    key = f"{collection}.{path}.{jleaf}"
    if _FLAT_MLP.fullmatch(path):  # decoder.x_mlp.fc0.kernel -> decoder.x_mlp.fc0_kernel
        key = f"{collection}.{path}_{jleaf}"
    return key, jleaf in _TRANSPOSED


def state_dict_to_bundle(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bundle_to_state_dict`: a port ``state_dict``
    as float32 ``{dotted key: array}`` in the JAX package's layout, which
    ``np.savez`` writes as a bundle the JAX package loads.  An entry with no
    counterpart raises."""
    out: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        key, transposed = bundle_key(name, t)
        arr = t.detach().cpu().float().numpy()
        if transposed:  # OIHW -> HWIO, [out, in] -> [in, out]
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        out[key] = np.ascontiguousarray(arr)
    return out
