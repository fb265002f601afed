"""Full DeepLabV3+ model: backbone → encoder middle (ASPP DAG) → decoder
(port of ``deeplabv3plus_keras_tpu/models/deeplab.py:28-105``).

The public layout is the JAX package's: images (B, S, S, 3) NHWC in
(−1, 1) in, NHWC probabilities (B, S, S, classes) out (or NHWC
pre-upsample logits and the upsample factor).  Inside, tensors are NCHW
in ``channels_last`` memory, which is physically NHWC: the permutes at
the two ends are views, not copies.  The backbone runs once and feeds
both the encoder and the boundary refinement, as in the JAX package.

``hps.dtype`` is the compute dtype (``_DTYPES``, JAX ``models/deeplab.py:
27-41``): the images are cast to it once, before the backbone (EfficientNet
casts them itself, after its float32 normalisation prologue, where the
JAX backbone's first conv casts them), every layer computes in it
(``models/blocks.py``), and the outputs are at least float32.  The
parameters and BN statistics keep their own dtype (float32).  The extra
key ``remat`` recomputes the backbone's activations in the backward pass
(``torch.utils.checkpoint``, JAX ``nn.remat``): training only, the BN
running statistics moved once, by the first forward, and the recompute
drawing EfficientNet's stochastic-depth masks again from the generator's
state before the first forward, as ``nn.remat`` replays its key.  Under
``mesh_space`` the recompute replays the backbone's row fetches and BN's
all-reduces, on the backward's thread with the forward's map of global
heights, and recomputes the whole backbone on every rank, so that every
rank enters the same exchanges (``parallel/spatial.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..config import Config
from ..parallel import spatial
from .backbones import get_backbone
from .blocks import init_weights, running_stats_frozen
from .decoder import Decoder
from .encoder import EncoderMiddle

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    # the float64 parity tests' dtype; never a production dtype
    "float64": torch.float64,
}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of an ``hps.dtype`` name."""
    if name not in _DTYPES:
        raise ValueError(f"hps.dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@contextlib.contextmanager
def _recompute(generator: torch.Generator | None, state: torch.Tensor | None, heights):
    """Around the backbone's recompute: BN's running statistics frozen, the
    first forward's global heights (``heights``, under ``mesh_space``), and
    ``generator`` wound back to ``state`` (its state before the first
    forward) so that the recompute draws the same masks; afterwards the
    generator is where the step had left it."""
    with running_stats_frozen(), spatial.use_heights(heights):
        if generator is None:
            yield
            return
        after = generator.get_state()
        generator.set_state(state)
        try:
            yield
        finally:
            generator.set_state(after)


def _remat_contexts(generator: torch.Generator | None):
    """``checkpoint``'s ``context_fn`` for one forward: nothing around the
    first forward, :func:`_recompute` around the recompute."""
    state = None if generator is None else generator.get_state()
    heights = spatial.heights()
    return lambda: (contextlib.nullcontext(), _recompute(generator, state, heights))


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Model outputs are ≥fp32: bf16/f16 compute upcasts, f64 passes through."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class DeepLabV3Plus(nn.Module):
    """conf: the full Config (hps + nn_arch drive every knob)."""

    def __init__(self, conf: Config):
        super().__init__()
        arch, hps = conf.nn_arch, conf.hps
        self.compute_dtype = compute_dtype(hps.dtype)
        self.remat = bool(conf.extra.get("remat", False))
        self.base = get_backbone(conf.base_model, arch.output_stride, self.compute_dtype)
        self.encoder = EncoderMiddle(
            self.base.out_channels,
            arch.encoder_middle_conf,
            reduction_size=arch.reduction_size,
            concat_channels=arch.concat_channels,
            conv_rate_multiplier=arch.conv_rate_multiplier,
            dropout_rate=arch.dropout_rate,
            bn_momentum=hps.bn_momentum,
            bn_scale=hps.bn_scale,
        )
        self.decoder = Decoder(
            self.base.out_channels,
            arch.concat_channels,
            num_classes=arch.num_classes,
            output_stride=arch.output_stride,
            boundary_refinement=arch.boundary_refinement,
            bn_momentum=hps.bn_momentum,
            bn_scale=hps.bn_scale,
            fused_upconv=bool(conf.extra.get("fused_upconv", True)),
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every conv weight from ``generator``; BN starts at identity."""
        init_weights(self, generator)

    def forward(self, images: torch.Tensor, return_presample: bool = False,
                generator: torch.Generator | None = None):
        """``generator`` draws the dropout and stochastic-depth masks in
        training (required there when a rate is above 0)."""
        x = images.permute(0, 3, 1, 2)  # NHWC → NCHW view
        if not getattr(self.base, "casts_images", False):
            x = x.to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        if self.remat and self.training and torch.is_grad_enabled():
            # torch's global RNG is not drawn from; the generator is
            # replayed by the recompute's context.  Under mesh_space no rank
            # stops its recompute early: a rank holding no rows of a map
            # skips that map's op and saves fewer tensors, so its early stop
            # could fall before an exchange the other ranks enter
            with (set_checkpoint_early_stop(False) if spatial.active()
                  else contextlib.nullcontext()):
                base_features = checkpoint(self.base, x, generator, use_reentrant=False,
                                           context_fn=_remat_contexts(generator),
                                           preserve_rng_state=False)
        else:
            base_features = self.base(x, generator)
        encoder_features = self.encoder(base_features, generator)
        if return_presample:
            logits, up = self.decoder(base_features, encoder_features, return_presample=True)
            return _at_least_f32(logits.permute(0, 2, 3, 1)), up
        probs = self.decoder(base_features, encoder_features)
        return _at_least_f32(probs.permute(0, 2, 3, 1))
