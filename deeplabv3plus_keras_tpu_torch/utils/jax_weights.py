"""Carry the JAX package's variables into the port's model, and back.

``load_jax_variables(model, variables)`` takes the flax
``{'params': ..., 'batch_stats': ...}`` tree, as nested mappings of numpy
arrays, and fills the port's ``state_dict``; ``export_jax_variables(model)``
is its inverse.  The port's submodules carry
the flax names, so the mapping is mechanical:

- a path joins with ``.``; conv ``kernel`` (HWIO) → ``weight`` (OIHW), and
  a depthwise ``(k, k, 1, C)`` → ``(C, 1, k, k)`` by the same transpose;
- the JAX ``BatchNorm`` wrapper nests a flax ``nn.BatchNorm`` named
  ``bn``: ``.../X/bn/{scale, bias}`` → ``X.{weight, bias}`` and
  ``batch_stats .../X/bn/{mean, var}`` → ``X.{running_mean, running_var}``;
  with ``bn_scale=False`` there is no scale, and the port has no weight;
- a conv's ``bias`` (EfficientNet's squeeze-excite convs) →
  ``X.bias``;
- EfficientNet's input statistics ``batch_stats .../normalization_{mean,
  var}`` → the buffers of the same names.

Every leaf must land on one port tensor of the same shape, and every port
tensor must be filled: anything left over on either side raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..models.blocks import BatchNorm

# non-BN batch_stats leaves: buffers of the same name
_STAT_BUFFERS = ("normalization_mean", "normalization_var")

_BN_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _port_name(collection: str, path: tuple[str, ...]) -> tuple[str, bool]:
    """(port state_dict key, whether the value is an HWIO conv kernel)."""
    *mods, leaf = path
    if leaf == "kernel" and collection == "params":
        return ".".join(mods + ["weight"]), True
    bn = _BN_LEAVES.get((collection, leaf))
    if bn is not None and mods and mods[-1] == "bn":
        return ".".join(mods[:-1] + [bn]), False
    if (collection, leaf) == ("params", "bias") or (
            collection == "batch_stats" and leaf in _STAT_BUFFERS):
        return ".".join(path), False
    raise KeyError(f"no port counterpart for {collection}/{'/'.join(path)}")


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Fill ``model``'s parameters and buffers from a flax variable tree."""
    state = model.state_dict()
    filled: set[str] = set()
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name, is_kernel = _port_name(collection, path)
            if name not in state:
                raise KeyError(f"{collection}/{'/'.join(path)} → {name}: not in the port's model")
            arr = np.asarray(value)
            if is_kernel:
                arr = arr.transpose(3, 2, 0, 1)
            if tuple(arr.shape) != tuple(state[name].shape):
                raise ValueError(
                    f"{collection}/{'/'.join(path)}: shape {arr.shape} vs port {name} "
                    f"{tuple(state[name].shape)}"
                )
            if name in filled:
                raise KeyError(f"{name} filled twice")
            with torch.no_grad():
                state[name].copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port tensors with no JAX leaf: {missing}")
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise KeyError(f"unsupported variable collections: {sorted(extra)}")


def export_jax_variables(model: torch.nn.Module) -> dict[str, dict]:
    """The flax ``{'params', 'batch_stats'}`` tree of ``model``'s tensors,
    as nested dicts of numpy arrays: the inverse of :func:`load_jax_variables`."""
    bn_leaf = {port: (collection, leaf) for (collection, leaf), port in _BN_LEAVES.items()}
    bns = {name for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    out: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, value in model.state_dict().items():
        *mods, leaf = name.split(".")
        arr = value.detach().cpu().numpy()
        if ".".join(mods) in bns:
            collection, jleaf = bn_leaf[leaf]
            path = mods + ["bn", jleaf]
        elif leaf == "weight" and arr.ndim == 4:
            collection, path = "params", mods + ["kernel"]
            arr = arr.transpose(2, 3, 1, 0)
        elif leaf == "bias":
            collection, path = "params", mods + [leaf]
        elif leaf in _STAT_BUFFERS:
            collection, path = "batch_stats", mods + [leaf]
        else:
            raise KeyError(f"no JAX leaf for port tensor {name}")
        node = out[collection]
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out
