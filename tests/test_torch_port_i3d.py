"""The port's I3D package against ``vct_tpu.i3d`` on the CPU: ``Unit3D``,
the SAME max pools and ``InceptionModule`` on weights carried across by
``unit_state_dict_from_jax``, the whole tower on a seeded Kinetics-layout
state dict (RGB, flow and the logits head), the converter's BatchNorm fold,
and the host copies (crop, stacks, optical flow).

Tolerance: the towers and blocks in float32 at rtol = atol = 2e-4, the CLIP
towers' bound (measured: 7e-5 at features of magnitude up to 3e2); the max
pools, the converter's ``scale`` / ``offset``, the crop, the stacks and the
flow fields exactly (the same float32 formulas, or copies of the same code).
The tower runs at (1, 9, 200, 200, C): the smallest clip whose odd sizes go
through the asymmetric SAME pads at 100 -> 50 -> 25 -> 13 -> 7 and still
leave the (2, 7, 7) VALID pool a window.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vct_tpu.i3d import I3DTower as JaxTower
from vct_tpu.i3d import convert_i3d as j_convert_i3d
from vct_tpu.i3d import flow as jflow
from vct_tpu.i3d import model as jmodel
from vct_tpu_torch.i3d import I3DTower, convert_i3d, flow, model
from vct_tpu_torch.i3d.convert import i3d_state_dict_from_jax, unit_state_dict_from_jax
from vct_tpu_torch.i3d.model import INCEPTION_CHANNELS, InceptionModule, Unit3D, max_pool_same

from tests.test_i3d import _synthetic_state_dict

TOL = dict(rtol=2e-4, atol=2e-4)
_j_unit = j_convert_i3d.__globals__["_unit"]  # the reference converter's unit


def _unit_sd(rng, prefix, cin, cout, k):
    return {f"{prefix}.conv3d.weight": rng.randn(cout, cin, *k).astype(np.float32) * 0.2,
            f"{prefix}.bn.weight": rng.rand(cout).astype(np.float32) + 0.5,
            f"{prefix}.bn.bias": rng.randn(cout).astype(np.float32) * 0.1,
            f"{prefix}.bn.running_mean": rng.randn(cout).astype(np.float32) * 0.1,
            f"{prefix}.bn.running_var": rng.rand(cout).astype(np.float32) + 0.5}


def _ncdhw(x):
    return torch.tensor(x).permute(0, 4, 1, 2, 3)


def _ndhwc(t):
    return t.permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 6, 9, 9, 5), (1, 8, 10, 12, 5)], ids=["odd", "even"])
@pytest.mark.parametrize("k,s", [((1, 1, 1), (1, 1, 1)), ((3, 3, 3), (1, 1, 1)),
                                 ((7, 7, 7), (2, 2, 2))], ids=["1x1x1", "3x3x3", "7x7x7s2"])
def test_unit3d_matches_reference(k, s, shape):
    rng = np.random.RandomState(k[0] * 10 + s[0] + shape[2])
    params = _j_unit(_unit_sd(rng, "u", 5, 8, k), "u")
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jmodel.Unit3D(8, k, s).apply({"params": params}, jnp.asarray(x)))
    unit = Unit3D(5, 8, k, s)
    unit.load_state_dict(unit_state_dict_from_jax(params))
    with torch.no_grad():
        got = _ndhwc(unit(_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 9, 11, 3), (1, 6, 8, 10, 3)], ids=["odd", "even"])
@pytest.mark.parametrize("k,s", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)),
                                 ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))],
                         ids=["1x3x3s122", "3x3x3s2", "2x2x2s2", "3x3x3s1"])
def test_same_max_pool_matches_reference(k, s, shape):
    """Negative inputs, so a zero pad would show where -inf belongs."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32) - 1.0
    want = np.asarray(jmodel._max_pool(jnp.asarray(x), k, s))
    got = _ndhwc(max_pool_same(_ncdhw(x), k, s))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_inception_module_matches_reference():
    ch = (4, 4, 8, 2, 4, 4)
    rng = np.random.RandomState(7)
    cin = 10
    sd = {}
    for b, (i, o, k) in {"b0": (cin, 4, (1, 1, 1)), "b1a": (cin, 4, (1, 1, 1)),
                         "b1b": (4, 8, (3, 3, 3)), "b2a": (cin, 2, (1, 1, 1)),
                         "b2b": (2, 4, (3, 3, 3)), "b3b": (cin, 4, (1, 1, 1))}.items():
        sd.update(_unit_sd(rng, f"M.{b}", i, o, k))
    params = {b: _j_unit(sd, f"M.{b}") for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")}
    x = rng.randn(2, 5, 7, 8, cin).astype(np.float32)
    want = np.asarray(jmodel.InceptionModule(ch).apply({"params": params}, jnp.asarray(x)))
    block = InceptionModule(cin, ch)
    block.load_state_dict({f"{b}.{k}": v for b, p in params.items()
                           for k, v in unit_state_dict_from_jax(p).items()})
    with torch.no_grad():
        got = _ndhwc(block(_ncdhw(x)))
    assert got.shape == want.shape == (2, 5, 7, 8, 20) and block.out_channels == 20
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("channels,with_logits", [(3, False), (2, False), (3, True)],
                         ids=["rgb", "flow", "rgb_logits"])
def test_tower_matches_reference(channels, with_logits):
    sd = _synthetic_state_dict(np.random.RandomState(3 + channels), in_channels=channels)
    x = np.random.RandomState(5).rand(1, 9, 200, 200, channels).astype(np.float32) * 2 - 1
    params = j_convert_i3d(sd, with_logits=with_logits)
    want = np.asarray(JaxTower(with_logits=with_logits).apply({"params": params},
                                                              jnp.asarray(x)))
    tower = I3DTower(channels, with_logits=with_logits)
    tower.load_state_dict(convert_i3d(sd, with_logits=with_logits))  # strict
    with torch.no_grad():
        got = tower(torch.tensor(x))
        got64 = tower.double()(torch.tensor(x)).float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape == (1, 400 if with_logits else 1024)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got64.numpy(), want, **TOL)


@pytest.mark.parametrize("with_logits", [False, True])
def test_convert_i3d_folds_as_the_reference(with_logits):
    """Every conv weight under its source key and layout, ``scale`` /
    ``offset`` with the reference fold's bits, and the Flax params carried
    back by ``i3d_state_dict_from_jax`` to the same state dict, which loads
    with nothing missing and nothing unexpected."""
    sd = _synthetic_state_dict(np.random.RandomState(11))
    got = convert_i3d(sd, with_logits=with_logits)
    params = j_convert_i3d(sd, with_logits=with_logits)
    units = ["Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"] + [
        f"{name}.{b}" for name, _ in INCEPTION_CHANNELS
        for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")]
    for unit in units:
        p = params
        for part in unit.split("."):
            p = p[part]
        np.testing.assert_array_equal(got[f"{unit}.conv3d.weight"].numpy(),
                                      sd[f"{unit}.conv3d.weight"])
        for name in ("scale", "offset"):
            assert got[f"{unit}.{name}"].dtype == torch.float32
            np.testing.assert_array_equal(got[f"{unit}.{name}"].numpy(), p[name])
    assert ("logits.conv3d.bias" in got) == with_logits
    assert len(got) == 3 * len(units) + 2 * with_logits
    carried = i3d_state_dict_from_jax(params)
    assert carried.keys() == got.keys()
    for key, value in got.items():
        np.testing.assert_array_equal(carried[key].numpy(), value.numpy())
    report = I3DTower(with_logits=with_logits).load_state_dict(carried, strict=False)
    assert not report.missing_keys and not report.unexpected_keys


def test_tower_keys_and_parameter_count():
    """The Kinetics tower's ~12.3 M parameters, keyed like the source
    checkpoint; the flow stem takes 2 channels."""
    rgb, flow_tower = I3DTower(3), I3DTower(2)
    n = sum(p.numel() for p in rgb.parameters())
    assert 12_200_000 < n < 12_400_000, n
    assert flow_tower.Conv3d_1a_7x7.conv3d.weight.shape == (64, 2, 7, 7, 7)
    assert "Mixed_5c.b3b.conv3d.weight" in rgb.state_dict()
    assert not hasattr(rgb, "logits") and hasattr(I3DTower(with_logits=True), "logits")


def _frames(n, h=120, w=160, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("n", [1, 5])
def test_host_preprocessing_equals_the_reference(n):
    frames = _frames(n, seed=n)
    for name in ("resize_center_crop", "preprocess_i3d_frames"):
        np.testing.assert_array_equal(getattr(model, name)(frames),
                                      getattr(jmodel, name)(frames))
    cropped = model.resize_center_crop(frames)
    np.testing.assert_array_equal(model.scale_i3d_frames(cropped),
                                  jmodel.scale_i3d_frames(cropped))
    np.testing.assert_array_equal(flow.flow_from_cropped(cropped),
                                  jflow.flow_from_cropped(cropped))
    np.testing.assert_array_equal(flow.preprocess_i3d_flow(frames),
                                  jflow.preprocess_i3d_flow(frames))
    if n > 1:
        np.testing.assert_array_equal(flow.estimate_flow(frames), jflow.estimate_flow(frames))
    else:
        with pytest.raises(ValueError, match="at least 2"):
            flow.estimate_flow(frames)


@pytest.mark.parametrize("t", [1, 10, 64, 65, 130])
def test_i3d_stacks_equal_the_reference(t):
    frames = np.arange(t)[:, None, None, None] * np.ones((1, 2, 2, 3), np.float32)
    got = model.i3d_stacks(frames)
    np.testing.assert_array_equal(got, jmodel.i3d_stacks(frames))
    assert got.shape == (max(1, 1 + (t - 64) // 64), 64, 2, 2, 3)
    np.testing.assert_array_equal(model.i3d_stacks(frames, stack=4, step=3),
                                  jmodel.i3d_stacks(frames, stack=4, step=3))
    with pytest.raises(ValueError, match="no frames"):
        model.i3d_stacks(frames[:0])


def test_stack_features_is_one_tower_call_per_clip():
    """``stack_features`` stacks the tower's output of each clip in order;
    a tower that reports its clip's first frame index shows the order."""
    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.Conv3d_1a_7x7 = torch.nn.Module()
            self.Conv3d_1a_7x7.conv3d = torch.nn.Conv3d(1, 1, 1)
            self.calls = 0

        def forward(self, clip):
            self.calls += 1
            assert clip.shape == (1, 64, 2, 2, 3)
            return clip[:, 0, 0, 0, :1].expand(1, 1024)

    frames = np.arange(130)[:, None, None, None] * np.ones((1, 2, 2, 3), np.float32)
    probe = Probe()
    got = model.stack_features(probe, frames)
    assert probe.calls == 2 and got.shape == (2, 1024) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], [0, 64])
