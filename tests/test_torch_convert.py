"""Port vs JAX: the torchvision VGG16 converter (convert/vgg_import.py).

On tests/test_vgg_convert.py's fake state_dict the port's flat dict equals
the JAX package's bit for bit (keys, shapes, dtype, values); conv5 and the
classifier are skipped and a missing conv is named.  The whole route of a
user, `.pth` -> `python -m deepinpainting_torch.convert.vgg_import` -> npz
-> Config(vgg_weights=...) -> init_params, gives a VGG whose features match
torchvision's slice structure recomputed in torch (1e-5) and the JAX
package's apply_vgg16 on the same npz (its test's 1e-4).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from deepinpainting_tpu.convert.vgg_import import (
    convert_vgg16_state_dict as jax_convert)
from deepinpainting_tpu.models.vgg16 import apply_vgg16, load_params_npz
from deepinpainting_torch.config import Config
from deepinpainting_torch.convert import (convert_vgg16_state_dict,
                                          torch_file_to_npz)
from deepinpainting_torch.convert.vgg_import import VGG16_FEATURES_INDEX
from deepinpainting_torch.engine import inpaint as TI

from test_vgg_convert import CHANNELS, torch_vgg_slices
from torch_reference_layout import (VGG16_CONVS, reference_vgg_state_dict,
                                    torchvision_relu4_3)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


@pytest.fixture(scope="module")
def fake_state_dict():
    """tests/test_vgg_convert.py's: the ten slice convs from seed 0, and
    distractors the converter must skip."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    for idx, name in VGG16_FEATURES_INDEX.items():
        cin, cout = CHANNELS[name]
        sd[f"features.{idx}.weight"] = torch.randn(
            (cout, cin, 3, 3), generator=g) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn((cout,), generator=g) * 0.05
    sd["features.24.weight"] = torch.zeros((512, 512, 3, 3))
    sd["features.24.bias"] = torch.zeros((512,))
    sd["classifier.0.weight"] = torch.zeros((8, 8))
    return sd


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["bare", "prefixed", "numpy"])
def test_flat_dict_equals_jax(fake_state_dict, layout):
    sd = fake_state_dict
    if layout == "prefixed":
        sd = {f"vgg.{k}": v for k, v in sd.items()}
    elif layout == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    got = convert_vgg16_state_dict(sd)
    _assert_same(got, jax_convert(fake_state_dict))
    assert len(got) == 20 and "conv5_1_kernel" not in got
    assert got["conv1_1_kernel"].shape == (3, 3, 3, 64)
    assert all(a.flags["C_CONTIGUOUS"] for a in got.values())


@pytest.mark.parametrize("drop,named", [("features.10.weight", "conv3_1"),
                                        ("features.21.bias", "conv4_3")])
def test_missing_conv_raises(fake_state_dict, drop, named):
    sd = dict(fake_state_dict)
    del sd[drop]
    with pytest.raises(ValueError, match=named):
        convert_vgg16_state_dict(sd)


def test_pickled_module_converts_as_its_state_dict(fake_state_dict,
                                                   tmp_path):
    """A .pth holding a whole module (torchvision's model pickled) gives
    the npz its state_dict gives."""
    layers = [nn.Identity() for _ in range(23)]
    for idx, name in VGG16_FEATURES_INDEX.items():
        cin, cout = CHANNELS[name]
        layers[idx] = nn.Conv2d(cin, cout, 3, padding=1)
    model = nn.Module()
    model.features = nn.Sequential(*layers)
    model.load_state_dict({k: v for k, v in fake_state_dict.items()
                           if int(k.split(".")[1]) < 23
                           and k.startswith("features.")})
    torch.save(model, tmp_path / "model.pth")
    torch_file_to_npz(str(tmp_path / "model.pth"), str(tmp_path / "m.npz"))
    with np.load(tmp_path / "m.npz") as raw:
        _assert_same(dict(raw), jax_convert(fake_state_dict))


def test_file_route_to_the_port_vgg(fake_state_dict, tmp_path):
    pth, npz = tmp_path / "vgg16.pth", tmp_path / "vgg16.npz"
    torch.save(fake_state_dict, pth)
    res = subprocess.run(
        [sys.executable, "-m", "deepinpainting_torch.convert.vgg_import",
         str(pth), str(npz)], cwd=REPO, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr
    assert f"wrote {npz}" in res.stdout

    cfg = Config(fine_size=64, ngf=64, vgg_width_scale=1.0,
                 vgg_weights=str(npz))
    vgg = TI.init_params(cfg, torch.Generator().manual_seed(0), "cpu").vgg
    x = torch.randn((1, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        got = vgg(x)
    want = torch_vgg_slices(fake_state_dict, x)
    jax_got = apply_vgg16(load_params_npz(str(npz)),
                          jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    for name, w, j in zip(got._fields, want, jax_got):
        g = getattr(got, name)
        assert (g - w).abs().max().item() <= TOL, name
        np.testing.assert_allclose(np.asarray(j),
                                   g.numpy().transpose(0, 2, 3, 1),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_chip_smoke_standin_vgg(fake_state_dict):
    """chip_smoke.py's torchvision-layout VGG (thirteen convs) converts to
    the ten slice convs, and its relu4_3 recomputation is the slice
    structure's."""
    sd = reference_vgg_state_dict(torch.Generator().manual_seed(3))
    assert len(sd) == 2 * len(VGG16_CONVS) == 26
    assert sorted(convert_vgg16_state_dict(sd)) == sorted(
        jax_convert(fake_state_dict))
    x = torch.randn((1, 3, 16, 16), generator=torch.Generator()
                    .manual_seed(2))
    assert torch.equal(torchvision_relu4_3(fake_state_dict, x),
                       torch_vgg_slices(fake_state_dict, x)[-1])
