"""Weight bridge: the JAX package's flat parameter bundle -> the port's
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
