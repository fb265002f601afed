"""Xception as the Keras reference cuts it: at ``block13_sepconv2_bn``
(output stride 16) or ``block4_sepconv2_bn`` (8); BN momentum 0.99,
``VALID`` entry convs, 3×3 stride-2 ``SAME`` max pools."""

from __future__ import annotations

import torch.nn.functional as F

from benchmark.reference.model import Run, _Spec, bn, conv, depthwise, max_pool_same

ENTRY = ((2, 64, 128), (3, 128, 256), (4, 256, 728))  # (block, in, out)


def _sep_spec(s: _Spec, block: int, i: int, cin: int, cout: int) -> None:
    name = f"base.block{block}_sepconv{i}"
    s.conv(f"{name}.depthwise", cin, 1, 3)
    s.conv(f"{name}.pointwise", cout, cin, 1)
    s.bn(f"{name}_bn", cout)


def spec(s: _Spec, os_: int) -> int:
    s.conv("base.block1_conv1", 32, 3, 3)
    s.bn("base.block1_conv1_bn", 32)
    s.conv("base.block1_conv2", 64, 32, 3)
    s.bn("base.block1_conv2_bn", 64)
    for j, (b, cin, cout) in enumerate(ENTRY):
        suffix = f"_{j}" if j else ""
        s.conv(f"base.conv2d{suffix}", cout, cin, 1)
        s.bn(f"base.batch_normalization{suffix}", cout)
        _sep_spec(s, b, 1, cin, cout)
        _sep_spec(s, b, 2, cout, cout)
    if os_ == 8:
        return 728
    for b in range(5, 13):
        for i in range(1, 4):
            _sep_spec(s, b, i, 728, 728)
    _sep_spec(s, 13, 1, 728, 728)
    _sep_spec(s, 13, 2, 728, 1024)
    return 1024


def _sep(run: Run, x, block: int, i: int):
    name = f"base.block{block}_sepconv{i}"
    x = depthwise(run, f"{name}.depthwise", x)
    return bn(run, f"{name}_bn", conv(x, run.p[f"{name}.pointwise.weight"]), 0.99)


def forward(run: Run, x, os_: int):
    p = run.p
    x = F.relu(bn(run, "base.block1_conv1_bn",
                  conv(x, p["base.block1_conv1.weight"], 2, padding="VALID"), 0.99))
    x = F.relu(bn(run, "base.block1_conv2_bn",
                  conv(x, p["base.block1_conv2.weight"], padding="VALID"), 0.99))
    for j, (b, _, _) in enumerate(ENTRY):
        suffix = f"_{j}" if j else ""
        res = bn(run, f"base.batch_normalization{suffix}",
                 conv(x, p[f"base.conv2d{suffix}.weight"], 2), 0.99)
        if b > 2:
            x = F.relu(x)
        x = _sep(run, F.relu(_sep(run, x, b, 1)), b, 2)
        if b == 4 and os_ == 8:
            return x
        x = max_pool_same(x) + res
    for b in range(5, 13):
        res = x
        for i in range(1, 4):
            x = _sep(run, F.relu(x), b, i)
        x = x + res
    x = _sep(run, F.relu(x), 13, 1)
    return _sep(run, F.relu(x), 13, 2)
