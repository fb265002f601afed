"""Model export on the port (``convert_to_tf_lite``, JAX ``api.py:650-729``):
a ``torch.export`` program of the inference forward with a dynamic batch
dimension, ``work_dir/semantic_segmentation_deeplabv3plus.pt2``, on the CPU.

On the card the depthwise sites are the custom operators
``dlv3_port::depthwise_fwd`` (K2/K3) and ``dlv3_port::depthwise_cf_fwd``
(K6), so that the export records the kernels rather than tracing into a
ctypes launch.  Here the wrappers take the plain versions; the operators'
wiring (fake kernel, registered gradient, export) is checked on the CPU
with the launches standing in as their plain versions.

Tolerances: the loaded program runs the same operations as the model, so
its probabilities equal the model's to 1e-6; against JAX ``apply`` the
full-model parity bound of tests/test_torch_model.py (1e-5 on the
probabilities).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplabv3plus_keras_tpu_torch import SemanticSegmentation, cli
from deeplabv3plus_keras_tpu_torch.kernels import depthwise, depthwise_conv_plain
from deeplabv3plus_keras_tpu_torch.utils.jax_weights import load_jax_variables

from torch_helpers import conf_dict, jax_model_and_traced_variables

torch.set_num_threads(1)
DEPTHWISE_OPS = (torch.ops.dlv3_port.depthwise_fwd.default,
                 torch.ops.dlv3_port.depthwise_cf_fwd.default)


def _images(n, size=64, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3))
                            .astype(np.float32))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX model, variables, facade, paths written, loaded program)."""
    conf = conf_dict(64)
    jm, v = jax_model_and_traced_variables(conf, seed=7)
    work = tmp_path_factory.mktemp("export")
    seg = SemanticSegmentation(conf, work_dir=str(work), device="cpu")
    load_jax_variables(seg.model, v)
    paths = seg.convert_to_tf_lite()
    return jm, v, seg, paths, torch.export.load(paths[0])


def test_convert_writes_the_program(exported, capsys):
    _, _, seg, paths, program = exported
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["semantic_segmentation_deeplabv3plus.pt2"]
    spec = program.graph_signature.user_inputs
    assert len(spec) == 1
    # float32 parameters, eval-mode BN: no buffer is mutated by the program
    assert not program.graph_signature.buffers_to_mutate
    assert all(t.dtype == torch.float32 for t in program.state_dict.values())


@pytest.mark.parametrize("batch", [1, 3])
def test_loaded_program_equals_model_and_jax(exported, batch):
    jm, v, seg, _, program = exported
    x = _images(batch)
    with torch.no_grad():
        got = program.module()(x)
        ref = seg.model.eval()(x)
    assert tuple(got.shape) == (batch, 64, 64, 21) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    jp = np.asarray(jm.apply(v, jnp.asarray(x.numpy()), train=False))
    np.testing.assert_allclose(got.numpy(), jp, atol=1e-5, rtol=0)


def test_representative_images_raise_naming_int8(exported):
    """Representative images (int8 calibration) no longer raise: they add
    the calibrated int8 program beside the float one (JAX's third artifact,
    ``TF_LITE_INT8_MODEL_PATH``); tests/test_torch_int8_api.py checks its
    numbers."""
    _, _, seg, paths, _ = exported
    both = seg.convert_to_tf_lite(representative_images=_images(2).numpy())
    assert [p.rsplit("/", 1)[-1] for p in both] == [
        "semantic_segmentation_deeplabv3plus.pt2", "semantic_segmentation_deeplabv3plus_int8.pt2"]
    assert both[0] == paths[0]


def test_cli_converts(tmp_path, monkeypatch, capsys):
    """The CLI's convert_to_tf_lite mode writes the program into the working
    directory."""
    conf = {**conf_dict(32), "mode": "convert_to_tf_lite"}
    (tmp_path / "conf.json").write_text(json.dumps(conf))
    monkeypatch.chdir(tmp_path)
    assert cli.main([str(tmp_path / "conf.json"), "--device", "cpu"]) == 0
    assert "no .tflite written" in capsys.readouterr().out
    program = torch.export.load(str(tmp_path / "semantic_segmentation_deeplabv3plus.pt2"))
    assert tuple(program.module()(_images(2, 32)).shape) == (2, 32, 32, 21)


@pytest.fixture
def ops_on_cpu(monkeypatch):
    """The depthwise wrappers route CPU tensors through the custom
    operators, whose launches run the plain versions (the card's path,
    rehearsed on the CPU)."""
    def launch(x, weight, stride, dilation, window=None):
        return depthwise_conv_plain(x, weight, stride, dilation, window).contiguous(
            memory_format=torch.channels_last)

    def launch_backward(x, weight, g, stride, dilation, want_dx, want_dk, window=None):
        dx, dk = depthwise.depthwise_conv_backward_plain(x, weight, g, stride, dilation, window)
        return (dx if want_dx else None), (dk if want_dk else None)

    monkeypatch.setattr(depthwise, "_launch", launch)
    monkeypatch.setattr(depthwise, "_launch_backward", launch_backward)
    monkeypatch.setattr(depthwise, "_on_card", lambda *a: True)


@pytest.mark.parametrize("stride,dilation,layout", [(1, (1, 1), "nhwc"), (2, (1, 1), "nhwc"),
                                                     (1, (2, 3), "nhwc"), (1, (1, 1), "bhcw")])
def test_depthwise_custom_ops_forward_and_gradient(ops_on_cpu, monkeypatch, stride, dilation,
                                                   layout):
    """Through the operator: the plain forward, and its registered gradient
    equal to autograd of the plain version."""
    monkeypatch.setenv("DLV3_DW_LAYOUT", layout)
    if layout == "bhcw":  # K6/K7 stand-ins: the channels-first plain versions
        monkeypatch.setattr(depthwise, "_cf_forward", lambda x, w: depthwise_conv_plain(x, w))
        monkeypatch.setattr(depthwise, "depthwise_cf_backward",
                            lambda x, w, g, want_dx, want_dk:
                            depthwise.depthwise_conv_backward_plain(x, w, g))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 11, generator=gen).contiguous(memory_format=torch.channels_last)
    w = torch.randn(8, 1, 3, 3, generator=gen)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = depthwise.depthwise_conv(xa, wa, stride, dilation)
    ref = depthwise_conv_plain(xb, wb, stride, dilation)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-6)
    g = torch.randn(ref.shape, generator=gen)
    (y * g).sum().backward()
    (ref * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(wa.grad, wb.grad, rtol=0, atol=1e-5)


def test_export_records_the_depthwise_ops(ops_on_cpu, tmp_path):
    """With the operators on the path (as on the card), the exported graph
    holds one depthwise node per site, its fake kernel gives the shapes
    for a dynamic batch, and the saved program runs at two batch sizes."""
    seg = SemanticSegmentation(conf_dict(64), work_dir=str(tmp_path), device="cpu")
    [path] = seg.convert_to_tf_lite()
    program = torch.export.load(path)
    nodes = [n for n in program.graph.nodes if n.target in DEPTHWISE_OPS]
    assert len(nodes) == 18  # 13 in the backbone, 5 in the ASPP
    for batch in (1, 3):
        x = _images(batch)
        with torch.no_grad():
            torch.testing.assert_close(program.module()(x), seg.model(x), rtol=0, atol=1e-6)


def test_launch_checks_channels_last():
    """The launch, not the wrapper, refuses an x that is not contiguous in
    channels_last memory (the export traces the wrapper with a symbolic
    batch, whose strides cannot prove it)."""
    w = torch.randn(8, 1, 3, 3)
    with pytest.raises(ValueError, match="channels_last"):
        depthwise._launch(torch.randn(1, 8, 6, 6), w, 1, (1, 1))
    with pytest.raises(ValueError, match="channels_last"):
        depthwise._launch_backward(torch.randn(1, 8, 6, 6), w, torch.randn(1, 8, 6, 6), 1, (1, 1),
                                   True, True)
