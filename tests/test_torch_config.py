"""The PyTorch port's config copy accepts and emits what the JAX package's does."""

import json

import pytest

from deeplabv3plus_keras_tpu import config as jax_config
from deeplabv3plus_keras_tpu_torch import config as port_config

from torch_helpers import conf_dict

CASES = {
    "flagship": conf_dict(512),
    "os8_pyramid_no_refine": conf_dict(96, output_stride=8, refine=False, pyramid=True),
    "extra_keys": conf_dict(64, remat=True, fused_upconv=False, eval_scales=[0.5, 1.0]),
    "nested_extra": {**conf_dict(64), "extra": {"int8_calib_batches": 2}, "top": 1},
    "defaults": {},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_matches_jax(name):
    d = CASES[name]
    port = port_config.Config.from_dict(d).to_dict()
    assert port == jax_config.Config.from_dict(d).to_dict()
    # and it is a fixed point
    assert port_config.Config.from_dict(port).to_dict() == port


def test_from_json(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text(json.dumps(conf_dict(128, pyramid=True)))
    c = port_config.Config.from_json(str(p))
    assert c.nn_arch.image_size == 128
    assert [m.op for m in c.nn_arch.encoder_middle_conf][-1] == "pyramid_pooling"
    assert c.nn_arch.encoder_middle_conf[1].rate == (18, 15)
    assert c.to_dict() == jax_config.Config.from_json(str(p)).to_dict()


@pytest.mark.parametrize("os_", [4, 32])
def test_output_stride_must_be_8_or_16(os_):
    with pytest.raises(ValueError, match="output_stride"):
        port_config.NNArch(output_stride=os_)


def test_invalid_middle_op_raises():
    with pytest.raises(ValueError, match="Invalid operation"):
        port_config.MiddleOp.from_dict({"op": "dilated_pool"})


def test_extra_keys_survive_and_merge_flat():
    c = port_config.Config.from_dict({"remat": True, "extra": {"a": 1, "remat": False}})
    assert c.extra == {"a": 1, "remat": True}
    assert c.to_dict()["a"] == 1 and c.to_dict()["remat"] is True
