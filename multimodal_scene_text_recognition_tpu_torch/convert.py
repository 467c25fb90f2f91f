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
"""

from __future__ import annotations

from typing import Dict, Mapping

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
_TRANSPOSED = {"kernel", "w_qkv", "w_out"}
_EMBEDDINGS = ("emb", "embed")
META_KEYS = ("__step__",)


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
        ok = (collection == "params" and leaf in _LEAF and leaf not in ("mean", "var")) or (
            collection == "batch_stats" and leaf in ("mean", "var"))
        if not ok or not path:
            raise KeyError(f"bundle key {key!r} has no counterpart in the port")
        name = f"{path}.{_LEAF[leaf]}"
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
    modules named ``emb`` and ``embed``, as in the JAX tree) or a kernel."""
    if leaf != "weight":
        return next(k for k, v in _LEAF.items() if v == leaf)
    if t.dim() == 1:
        return "scale"
    return "embedding" if path.rsplit(".", 1)[-1] in _EMBEDDINGS else "kernel"


def state_dict_to_bundle(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bundle_to_state_dict`: a port ``state_dict``
    as float32 ``{dotted key: array}`` in the JAX package's layout, which
    ``np.savez`` writes as a bundle the JAX package loads.  An entry with no
    counterpart raises."""
    port_leaves = sorted(set(_LEAF.values()), key=len, reverse=True)
    out: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        leaf = next((k for k in port_leaves if name.endswith("." + k)), None)
        if leaf is None:
            raise KeyError(f"state_dict entry {name!r} has no counterpart in a bundle")
        path = name[: -len(leaf) - 1]
        jleaf = _bundle_leaf(path, leaf, t)
        collection = "batch_stats" if jleaf in ("mean", "var") else "params"
        arr = t.detach().cpu().float().numpy()
        if jleaf in _TRANSPOSED:  # OIHW -> HWIO, [out, in] -> [in, out]
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        out[f"{collection}.{path}.{jleaf}"] = np.ascontiguousarray(arr)
    return out
