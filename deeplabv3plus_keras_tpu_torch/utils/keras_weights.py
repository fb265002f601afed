"""Keras → port weight conversion for the backbone zoo (port of
``deeplabv3plus_keras_tpu/utils/keras_weights.py``).

The reference builds its backbones from ``tf.keras.applications`` with
pretrained ImageNet weights (semantic_segmentation.py:494-771).  This
converter imports those weights into the port's model.

It keeps the JAX package's one naming map.  The port's modules carry the
flax names, so :func:`~.jax_weights.export_jax_variables` gives the model's
variables as the flax ``{'params', 'batch_stats'}`` tree; the JAX
package's name-driven walk (:func:`convert_keras_backbone`, here over
nested dicts of numpy arrays) replaces the backbone's leaves with the
Keras layers' weights, and :func:`~.jax_weights.load_jax_variables` loads
the tree back.  The expected Keras layer name of a flax path is its
components joined with ``_``, the trailing ``bn`` wrapper level dropped:

    ('block_1', 'expand', 'kernel')        → Conv  'block_1_expand'
    ('bn_Conv1', 'bn', 'scale')            → BN    'bn_Conv1'
    ('block2_sepconv1', 'depthwise', ...)  → SeparableConv 'block2_sepconv1'

and NASNet's cell/branch/inner nesting maps onto Keras's
``{inner}_{branch}_{cell_id}`` (:func:`_nasnet_layer_name`).

Layout transforms: Keras ``Conv2D`` kernels are HWIO, as flax's;
``DepthwiseConv2D`` kernels (kh, kw, cin, mult) transpose to the grouped
layout (kh, kw, mult, cin); a ``SeparableConv2D`` is one Keras layer whose
``depthwise_kernel`` and ``pointwise_kernel`` fill the port's split
depthwise and pointwise convs; BN (gamma, beta, moving_mean,
moving_variance) → (scale, bias) params + (mean, var) batch statistics,
i.e. the port's ``weight``, ``bias``, ``running_mean``, ``running_var``;
EfficientNet's ``normalization`` layer (mean, variance) → the buffers
``normalization_{mean,var}``.

Works with any weight source exposing the Keras layer API (an in-memory
model, ``weights=None`` random models for the parity tests included, or
one loaded from an .h5 file).  Nothing here imports TensorFlow or Keras.
"""

from __future__ import annotations

import copy
import re

import numpy as np


def _as_f32(w):
    """Weights land as float32, except float64 sources (a Keras model built
    under floatx float64), which stay float64."""
    a = np.asarray(w)
    return a if a.dtype == np.float64 else np.asarray(a, np.float32)


def _keras_layer_name(path: tuple[str, ...]) -> str:
    parts = list(path)
    if parts and parts[-1] == "bn":  # the BatchNorm wrapper level
        parts = parts[:-1]
    return "_".join(parts)


def _nasnet_layer_name(path: tuple[str, ...]) -> str | None:
    """NASNet flax path → Keras layer name.

    Keras NASNet layers are named ``{inner}_{branch?}_{cell_id}`` where
    cell_id ∈ {stem_1, stem_2, 0.., reduce_N}; the modules nest as
    cell/branch/inner:

        ('cell_0', 'normal_conv_1')                            → normal_conv_1_0
        ('cell_0', 'adjust', 'adjust_conv_projection')         → adjust_conv_projection_0
        ('reduce_4', 'reduction_left1', 'separable_conv_1_depthwise')
                                               → separable_conv_1_reduction_left1_reduce_4
        ('cell_0', 'normal_left1', 'separable_conv_1_bn', 'bn')
                                               → separable_conv_1_bn_normal_left1_0
    """
    head = path[0]
    if head.startswith("cell_"):
        cell_id = head[len("cell_"):]
    elif head.startswith(("stem_", "reduce_")):
        cell_id = head
    else:
        return None
    rest = [c for c in path[1:] if c != "adjust"]
    if rest and rest[-1] == "bn":
        rest = rest[:-1]
    if not rest:
        return None
    inner = rest[-1]
    for suffix in ("_depthwise", "_pointwise"):
        if inner.endswith(suffix):
            inner = inner[: -len(suffix)]
    branch = rest[0] if len(rest) > 1 else None
    return f"{inner}_{branch}_{cell_id}" if branch else f"{inner}_{cell_id}"


def _index_keras_weights(keras_model) -> dict[str, dict[str, np.ndarray]]:
    """layer name → {weight kind → array}.  The kind is the weight's own
    name (kernel / depthwise_kernel / pointwise_kernel / bias / gamma /
    beta / moving_mean / moving_variance / mean / variance)."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for layer in keras_model.layers:
        weights = layer.get_weights()
        if not weights:
            continue
        kinds = [w.name.split("/")[-1].split(":")[0] for w in layer.weights]
        # '/' in layer names (TF 2.4's DenseNet 'conv1/conv') becomes '_'
        out[layer.name.replace("/", "_")] = {k: np.asarray(v) for k, v in zip(kinds, weights)}

    # Keras's auto-numbered layer names ('conv2d_7', ...) depend on how many
    # models the process built before; renumber them from 0 in order, as a
    # fresh build names them (Xception's shortcut convs are named so)
    for prefix in ("conv2d", "batch_normalization", "separable_conv2d", "activation"):
        pat = re.compile(rf"^{prefix}(_\d+)?$")
        numbered = [n for n in out if pat.match(n)]
        if not numbered:
            continue
        numbered.sort(key=lambda n: int(n[len(prefix) + 1:]) if len(n) > len(prefix) else -1)
        canonical = [prefix if i == 0 else f"{prefix}_{i}" for i in range(len(numbered))]
        if numbered != canonical:
            renamed = {c: out.pop(n) for n, c in zip(numbered, canonical)}
            out.update(renamed)
    return out


def convert_keras_backbone(keras_model, variables, base_path: str = "base"):
    """A copy of the flax-shaped ``variables`` ({'params', 'batch_stats'},
    nested dicts of arrays) with the backbone subtree replaced by the Keras
    model's weights, and a report {'missing': [...], 'used': [...]}.
    ``base_path`` selects the backbone subtree ('' for a bare backbone's
    variables)."""
    kweights = _index_keras_weights(keras_model)
    used: set[str] = set()
    missing: list[str] = []
    params = copy.deepcopy(variables["params"])
    batch_stats = copy.deepcopy(variables.get("batch_stats", {}))

    def walk(ptree, btree, path):
        if isinstance(ptree, dict) and any(k in ptree for k in ("kernel", "scale", "bias", "mean")):
            name = _keras_layer_name(path)
            kw = kweights.get(name)
            if kw is None and path and path[-1] in ("depthwise", "pointwise"):
                # a Keras SeparableConv2D is one layer holding both kernels
                name = _keras_layer_name(path[:-1])
                kw = kweights.get(name)
            if kw is None:
                nn_name = _nasnet_layer_name(path)
                if nn_name is not None and nn_name in kweights:
                    kw, name = kweights[nn_name], nn_name
            if kw is None:
                missing.append(name)
                return
            used.add(name)
            if "kernel" in ptree:
                want = tuple(np.shape(ptree["kernel"]))
                if path[-1].endswith("depthwise") and "depthwise_kernel" in kw:
                    k = kw["depthwise_kernel"].transpose(0, 1, 3, 2)
                elif path[-1].endswith("pointwise") and "pointwise_kernel" in kw:
                    k = kw["pointwise_kernel"]
                elif "kernel" in kw:
                    k = kw["kernel"]
                    if k.shape != want and k.ndim == 4 and k.transpose(0, 1, 3, 2).shape == want:
                        k = k.transpose(0, 1, 3, 2)  # grouped/depthwise conv
                else:
                    missing.append(f"{name}:kernel")
                    return
                assert k.shape == want, (name, k.shape, want)
                ptree["kernel"] = _as_f32(k)
                if "bias" in ptree and "bias" in kw:
                    ptree["bias"] = _as_f32(kw["bias"])
            else:  # BatchNorm
                if "scale" in ptree and "gamma" in kw:
                    ptree["scale"] = _as_f32(kw["gamma"])
                if "bias" in ptree and "beta" in kw:
                    ptree["bias"] = _as_f32(kw["beta"])
                if btree is not None:
                    if "mean" in btree and "moving_mean" in kw:
                        btree["mean"] = _as_f32(kw["moving_mean"])
                    if "var" in btree and "moving_variance" in kw:
                        btree["var"] = _as_f32(kw["moving_variance"])
            return
        if isinstance(ptree, dict):
            for k in ptree:
                walk(ptree[k], btree.get(k) if isinstance(btree, dict) else None, path + (k,))

    p_sub = params[base_path] if base_path else params
    b_sub = (batch_stats[base_path] if base_path else batch_stats) if batch_stats else {}
    walk(p_sub, b_sub, ())

    # EfficientNet's weight-carrying Normalization layer (its statistics are
    # root-level batch_stats leaves of the backbone)
    if isinstance(b_sub, dict) and "normalization_mean" in b_sub:
        kw = kweights.get("normalization")
        if kw is not None:
            if "mean" in kw:
                b_sub["normalization_mean"] = _as_f32(kw["mean"]).reshape(-1)
            if "variance" in kw:
                b_sub["normalization_var"] = _as_f32(kw["variance"]).reshape(-1)
            used.add("normalization")

    new_vars = dict(variables)
    new_vars["params"] = params
    new_vars["batch_stats"] = batch_stats
    return new_vars, {"missing": missing, "used": sorted(used)}


def load_keras_h5_backbone(h5_path: str, builder, variables, base_path: str = "base"):
    """Convert from a saved Keras .h5/.keras file: ``builder()`` rebuilds
    the matching Keras architecture, whose weights are then loaded and
    converted."""
    model = builder()
    model.load_weights(h5_path)
    return convert_keras_backbone(model, variables, base_path)
