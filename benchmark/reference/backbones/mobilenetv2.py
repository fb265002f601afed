"""MobileNetV2 (alpha 1) as the Keras reference cuts it: after
``block_12_add`` (output stride 16) or ``block_5_add`` (8); ReLU6, BN
momentum 0.999."""

from __future__ import annotations

from benchmark.reference.model import Run, _Spec, bn, conv, depthwise, relu6

# inverted residual blocks 1..16: (features, stride, expansion)
PLAN = [(24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6), (32, 1, 6), (64, 2, 6),
        (64, 1, 6), (64, 1, 6), (64, 1, 6), (96, 1, 6), (96, 1, 6), (96, 1, 6),
        (160, 2, 6), (160, 1, 6), (160, 1, 6), (320, 1, 6)]


def spec(s: _Spec, os_: int) -> int:
    s.conv("base.Conv1", 32, 3, 3)
    s.bn("base.bn_Conv1", 32)
    s.conv("base.expanded_conv.depthwise", 32, 1, 3)
    s.bn("base.expanded_conv.depthwise_BN", 32)
    s.conv("base.expanded_conv.project", 16, 32, 1)
    s.bn("base.expanded_conv.project_BN", 16)
    cin = 16
    for i, (feat, _, t) in enumerate(PLAN[: 5 if os_ == 8 else 12], start=1):
        mid, b = cin * t, f"base.block_{i}"
        s.conv(f"{b}.expand", mid, cin, 1)
        s.bn(f"{b}.expand_BN", mid)
        s.conv(f"{b}.depthwise", mid, 1, 3)
        s.bn(f"{b}.depthwise_BN", mid)
        s.conv(f"{b}.project", feat, mid, 1)
        s.bn(f"{b}.project_BN", feat)
        cin = feat
    return cin


def forward(run: Run, x, os_: int):
    m = 0.999
    x = relu6(bn(run, "base.bn_Conv1", conv(x, run.p["base.Conv1.weight"], 2), m))
    b = "base.expanded_conv"
    x = relu6(bn(run, f"{b}.depthwise_BN", depthwise(run, f"{b}.depthwise", x), m))
    x = bn(run, f"{b}.project_BN", conv(x, run.p[f"{b}.project.weight"]), m)
    cin = 16
    for i, (feat, stride, _) in enumerate(PLAN[: 5 if os_ == 8 else 12], start=1):
        b, inputs = f"base.block_{i}", x
        x = relu6(bn(run, f"{b}.expand_BN", conv(x, run.p[f"{b}.expand.weight"]), m))
        x = relu6(bn(run, f"{b}.depthwise_BN", depthwise(run, f"{b}.depthwise", x, stride), m))
        x = bn(run, f"{b}.project_BN", conv(x, run.p[f"{b}.project.weight"]), m)
        if stride == 1 and cin == feat:
            x = x + inputs
        cin = feat
    return x
