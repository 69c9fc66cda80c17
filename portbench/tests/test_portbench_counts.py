"""counts.py against hand counts at a tiny size, its conv counts against
torch.utils.flop_counter on the reference's networks, and the kernels'
bounds against chip_smoke.py's arithmetic."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import TINY
from portbench import counts, harness
from portbench import weights as W
from portbench.reference import nets, step

SIZE = 64


@pytest.fixture(scope="module")
def tiny():
    cell = harness.load_cell("train-256-f32")
    cfg = harness.program_config(cell, **TINY)
    fam = harness.family_of(cell)
    shapes = W.shapes_of(fam.networks(cfg, train=True))
    w = W.draw(shapes, 5, torch.device("cpu"), fam.leaf_std(cfg))
    return cfg, shapes, w


def test_hand_counts(tiny):
    _, shapes, _ = tiny
    d = shapes["D"]
    # netD at 64 px, ndf 8: conv0 3->8 out 32; conv1 8->16 out 16;
    # conv2 16->32 out 8; conv3 32->64 s1 out 7; head 64->1 out 6
    hand = 2 * 16 * (3 * 8 * 32**2 + 8 * 16 * 16**2 + 16 * 32 * 8**2
                     + 32 * 64 * 7**2 + 64 * 1 * 6**2)
    assert counts.net_d_flops(d, SIZE) == hand
    # netF on relu3_3 (8x8, 32 ch at width 1/8) -> 4, 2, 1
    f = shapes["F"]
    assert counts.net_f_flops(f, SIZE) == 2 * 16 * (32 * 64 * 16 + 64 * 64 * 4
                                                    + 64 * 64 * 1)
    # the attention at level 3: N = 8*8, C = 64
    assert counts.attention_flops(shapes["G"], SIZE) == 2 * 64 * 64 * 64
    # VGG block 1 at 64 px: conv1_1 3->8, conv1_2 8->8
    v1 = counts.vgg_flops({k: s for k, s in shapes["vgg"].items()
                           if k.startswith("conv1")}, SIZE)
    assert v1 == 2 * 9 * (3 * 8 + 8 * 8) * 64**2


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_forward_counts_match_the_flop_counter(tiny):
    cfg, shapes, w = tiny
    prec = nets.Precision()
    f = counts.forward_flops(shapes, SIZE)
    x3 = torch.randn(2, 3, SIZE, SIZE)
    with torch.no_grad():
        assert _flops(lambda: nets.net_p(w["P"], x3, prec)) == 2 * f["P"]
        assert _flops(lambda: nets.vgg(w["vgg"], x3, prec)) == 2 * f["vgg4"]
        assert _flops(lambda: nets.vgg(w["vgg"], x3, prec, 3)) == \
            2 * f["vgg3"]
        assert _flops(lambda: nets.net_d(w["D"], x3, prec)) == 2 * f["D"]
        feat = nets.vgg(w["vgg"], x3, prec, 3)[2]
        assert _flops(lambda: nets.net_f(w["F"], feat, prec)) == 2 * f["F"]
        c = shapes["G"]["model.submodule.submodule.submodule.down_conv3"
                        ".weight"][0]
        ref_feat = torch.randn(2, c, SIZE // 8, SIZE // 8)
        flag = torch.zeros(2, (SIZE // 8) ** 2)
        flag[:, 10:20] = 1
        x6 = torch.randn(2, 6, SIZE, SIZE)
        got = _flops(lambda: nets.net_g(w["G"], x6, ref_feat, flag, prec))
        assert got == 2 * (f["G"] + f["attention"])


def test_serving_count_is_the_whole_inference(tiny):
    cfg, shapes, w = tiny
    img = torch.randint(0, 255, (2, SIZE, SIZE, 3), dtype=torch.uint8)
    mask = torch.zeros(2, SIZE, SIZE, dtype=torch.uint8)
    mask[:, 20:40, 20:40] = 255
    got = _flops(lambda: step.serve(w, img.numpy(), mask.numpy(), img.numpy(),
                                    step.config_dict(cfg), nets.Precision(),
                                    "cpu"))
    assert got == 2 * sum(counts.serve_flops(shapes, SIZE, "float32")
                          .values())


def test_train_count_by_precision(tiny):
    _, shapes, _ = tiny
    f = counts.forward_flops(shapes, SIZE)
    t32 = counts.train_flops(shapes, SIZE, "float32")
    t16 = counts.train_flops(shapes, SIZE, "bfloat16")
    assert sum(t32.values()) == pytest.approx(sum(t16.values()))
    assert t16["bfloat16"] == 3 * (f["P"] + f["G"])
    assert counts.least_seconds(t16) < counts.least_seconds(t32)


def test_kernel_bounds_are_chip_smokes():
    # chip_smoke.py::scan_bound / kbar_bound at N=1024, C=512, B=8 with
    # 252 masked rows a sample, and at N=4096, B=8
    b, n, c, m = 8, 1024, 512, 8 * 252
    nbytes = b * n * (4 + 4 * c + 4 * c + 8) + m * (4 * c + 4)
    assert counts.scan_bytes(b * n, m, c) == nbytes
    assert counts.scan_seconds(b * n, m, c) == pytest.approx(nbytes / 3.35e12)
    assert counts.kbar_bytes(8, 4096) == 8 * 4096 * 4096 * 4 + 8 * 4096 * 20
    assert counts.kbar_seconds(8, 4096) * 1e3 == pytest.approx(0.16046,
                                                               abs=1e-4)
