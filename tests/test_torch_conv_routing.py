"""Which convolutions take the hand-written f32 kernel (csrc/conv2d.cu), on
the CPU: ops/convs.py's routing rule, the two autograd.Functions around the
kernel's custom op (whose CPU implementation is F.conv2d), and the count
that `conv.hand_calls_per_step` reads on the card.

The card decides by the tensor's device (`convs._on_card`); these tests
open that gate for CPU tensors, so the routed calls run the custom op's
CPU twin and open their spans as on the card.
"""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from deepinpainting_torch.config import Config
from deepinpainting_torch.engine import inpaint as TI
from deepinpainting_torch.ops import conv_cuda, convs
from deepinpainting_torch.ops.convs import (ConvModes, Conv2d,
                                            ConvTranspose2d, HandConv2d,
                                            HandConvTranspose2d, use_modes)
from deepinpainting_torch.parallel.collectives import Spatial, use_spatial

from torch_conv_shapes import hand_calls_per_forward, hand_calls_per_step
from torch_port_helpers import TINY, tiny_batch

SPAN = "dip.hand.direct2d"


@pytest.fixture
def card_gate(monkeypatch):
    """The routing of a card, for CPU tensors, with every shape taken."""
    monkeypatch.setattr(convs, "_on_card", lambda x: True)
    monkeypatch.setattr(conv_cuda, "takes", lambda *shape: True)


@pytest.fixture
def op_calls(monkeypatch):
    """Calls of the kernel's custom op, by (x shape, w shape)."""
    calls = []
    real = convs.conv2d_f32

    def spy(x, w, bias, stride, padding, dilation):
        calls.append((tuple(x.shape), tuple(w.shape), stride, padding,
                      dilation))
        return real(x, w, bias, stride, padding, dilation)

    monkeypatch.setattr(convs, "conv2d_f32", spy)
    return calls


def _x(c=4, h=16, dtype=torch.float32, grad=False):
    x = torch.randn(2, c, h, h, dtype=dtype)
    return x.requires_grad_(grad)


LAYERS = {
    "k4s2p1": lambda: Conv2d(4, 8, 4, 2, 1),
    "k4s2p3d2": lambda: Conv2d(4, 4, 4, 2, 3, dilation=2),
    "k4s1p1": lambda: Conv2d(4, 8, 4, 1, 1, bias=False),
    "k3s1p1": lambda: Conv2d(4, 8, 3, 1, 1),
    "T_k4s2p1": lambda: ConvTranspose2d(4, 8, 4, 2, 1),
    "T_k3s1p1": lambda: ConvTranspose2d(4, 8, 3, 1, 1),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rule_takes_k4_forwards_and_transposed_input_gradients(
        card_gate, op_calls, name):
    torch.manual_seed(0)
    layer = LAYERS[name]()
    x = _x(grad=True)
    want = (F.conv_transpose2d if name.startswith("T") else F.conv2d)(
        x, layer.weight, layer.bias, layer.stride, layer.padding,
        dilation=layer.dilation)
    y = layer(x)
    routed_forward = name.startswith("k4")
    assert len(op_calls) == int(routed_forward)
    assert y.shape == want.shape
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    y.square().sum().backward()
    # the transposed conv's input gradient is the one extra call
    assert len(op_calls) == int(routed_forward) + int(name.startswith("T"))
    if name.startswith("T"):
        (xs, ws, s, p, d), = op_calls
        assert xs == tuple(y.shape) and ws == tuple(layer.weight.shape)
        assert (s, p, d) == (layer.stride[0], layer.padding[0], 1)


REFUSED = {
    "cpu": None,
    "bf16": None,
    "int8": lambda: use_modes(ConvModes(int8=True)),
    "pack_small_cin": lambda: use_modes(ConvModes(pack_small_cin=True)),
    "pack_out": lambda: use_modes(ConvModes(pack_out=True)),
    "slab": lambda: use_spatial(Spatial(None, 0, 2, None)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("kind", ["k4s2p1", "k4s2p3d2", "T_k4s2p1",
                                  "T_k3s1p1"])
def test_rule_refuses(monkeypatch, case, kind):
    """CPU tensors, bf16, every conv mode and a spatial slab keep the
    layer's own path."""
    if case != "cpu":
        monkeypatch.setattr(convs, "_on_card", lambda x: True)
    monkeypatch.setattr(conv_cuda, "takes", lambda *shape: True)
    layer = LAYERS[kind]()
    x = _x(dtype=torch.bfloat16 if case == "bf16" else torch.float32,
           grad=True)
    ctx = REFUSED[case]
    with ctx() if ctx else torch.enable_grad():
        assert convs._hand_routes(layer, x) is False


@pytest.mark.parametrize("kind", ["T_k4s2p1", "T_k3s1p1"])
def test_transposed_conv_routes_only_where_its_input_takes_a_gradient(
        card_gate, kind):
    layer = LAYERS[kind]()
    assert convs._hand_routes(layer, _x(grad=True))
    assert not convs._hand_routes(layer, _x(grad=False))
    with torch.no_grad():
        assert not convs._hand_routes(layer, _x(grad=True))


def test_rule_refuses_kernel_3_and_narrow_groups(card_gate):
    assert not convs._hand_routes(Conv2d(4, 8, 3, 1, 1), _x())
    assert not convs._hand_routes(Conv2d(4, 8, 4, 2, 1, groups=2), _x())
    assert not convs._hand_routes(Conv2d(4, 8, (4, 3), 2, 1), _x())
    assert not convs._hand_routes(
        ConvTranspose2d(4, 8, 4, 2, 1, output_padding=1), _x(grad=True))
    assert convs._hand_routes(Conv2d(4, 8, 4, 2, 1), _x())


@pytest.mark.parametrize("shape, hand", [
    ((7200, 1, 8192, 1, 1), False),         # netD's head, 256 px
    ((30752, 1, 8192, 1, 1), False),        # netD's head, 512 px
    ((8, 512, 8192, 2, 1), True),           # netP's innermost
    ((7688, 512, 4096, 1, 1), True),        # netD's conv3, 256 px
    ((31752, 512, 4096, 1, 1), False),      # netD's conv3, 512 px
    ((8192, 512, 4096, 2, 1), False),       # netF's conv0, 512 px
    ((2048, 512, 4096, 2, 1), True),        # netF's conv0, 256 px
    ((8192, 256, 4096, 2, 2), True),        # netG's third dilated conv
    ((131072, 64, 1024, 2, 2), False),      # netG's first dilated conv
    ((131072, 64, 48, 2, 1), True),         # netP's and netD's conv0
    ((8192, 1024, 2304, 1, 1), True),       # netG's k3 input gradient
    ((32768, 512, 1152, 1, 1), False),      # the next one out
])
def test_shape_rule_keeps_cudnn_where_the_card_showed_it_faster(shape,
                                                                 hand):
    assert conv_cuda.takes(*shape) is hand


GEOMETRIES = [(2, 1, 1, True), (2, 3, 2, True), (1, 1, 1, False),
              (2, 1, 1, False)]


@pytest.mark.parametrize("stride, padding, dilation, bias", GEOMETRIES)
def test_gradcheck_hand_conv2d(stride, padding, dilation, bias):
    g = torch.Generator().manual_seed(stride + padding)
    x = torch.randn(2, 3, 9, 9, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(5, 3, 4, 4, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = (torch.randn(5, generator=g, dtype=torch.float64, requires_grad=True)
         if bias else None)
    fn = lambda *t: HandConv2d.apply(t[0], t[1], t[2] if bias else None,
                                     stride, padding, dilation)
    assert torch.autograd.gradcheck(fn, (x, w, b) if bias else (x, w))


@pytest.mark.parametrize("k, stride, padding, bias",
                         [(4, 2, 1, True), (3, 1, 1, True), (4, 2, 1, False)])
def test_gradcheck_hand_conv_transpose2d(k, stride, padding, bias):
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 3, 5, 5, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(3, 4, k, k, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = (torch.randn(4, generator=g, dtype=torch.float64, requires_grad=True)
         if bias else None)
    fn = lambda *t: HandConvTranspose2d.apply(
        t[0], t[1], t[2] if bias else None, stride, padding)
    assert torch.autograd.gradcheck(fn, (x, w, b) if bias else (x, w))


def test_backward_takes_only_the_gradients_asked_for(card_gate, op_calls):
    layer = ConvTranspose2d(4, 8, 4, 2, 1)
    x = _x(grad=True)
    layer.weight.requires_grad_(False)
    layer.bias.requires_grad_(False)
    (gx,) = torch.autograd.grad(layer(x).sum(), (x,))
    assert len(op_calls) == 1 and gx.shape == x.shape
    conv = Conv2d(4, 8, 4, 2, 1)
    (gw,) = torch.autograd.grad(conv(_x()).sum(), (conv.weight,))
    assert gw.shape == conv.weight.shape


def test_export_records_the_custom_op(card_gate):
    """torch.export of a routed conv holds the op `deepinpainting::
    conv2d_f32` as one node (the serving artifact's graphs on the card)."""
    layer = Conv2d(4, 8, 4, 2, 1)
    x = _x()
    with torch.no_grad():
        ep = torch.export.export(layer, (x,))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert "deepinpainting.conv2d_f32.default" in targets
    with torch.no_grad():
        torch.testing.assert_close(ep.module()(x), layer(x), rtol=0, atol=0)


def test_export_with_a_symbolic_batch_records_the_op(card_gate):
    """A serving artifact's graph has a symbolic batch: the trace routes
    the kernel-4 Conv2d to the op without asking the shape rule (whose
    choice depends on the batch), and the graph answers at any batch."""
    layer = Conv2d(4, 8, 4, 2, 1)
    with torch.no_grad():
        ep = torch.export.export(
            layer, (_x(),), dynamic_shapes=({0: torch.export.Dim("b", min=1)},),
            strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert "deepinpainting.conv2d_f32.default" in targets
    for b in (1, 5):
        x = torch.randn(b, 4, 16, 16)
        with torch.no_grad():
            torch.testing.assert_close(ep.module()(x), layer(x), rtol=0,
                                       atol=0)


@pytest.mark.parametrize("taken", [True, False])
def test_op_on_the_card_applies_the_rule_at_run_time(monkeypatch, taken):
    """The op's CUDA implementation launches the kernel where
    conv_cuda.takes the call's GEMM (M = B x Ho x Wo at the batch the call
    brings) and leaves the rest to cuDNN."""
    asked, launched = [], []
    monkeypatch.setattr(conv_cuda, "takes",
                        lambda *shape: asked.append(shape) or taken)
    monkeypatch.setattr(conv_cuda, "conv2d_f32_cuda",
                        lambda *a: launched.append(a) or F.conv2d(*a))
    x, w, b = torch.randn(3, 4, 16, 16), torch.randn(8, 4, 4, 4), torch.randn(8)
    y = convs._conv2d_f32_cuda(x, w, b, 2, 3, 2)
    torch.testing.assert_close(y, F.conv2d(x, w, b, 2, 3, 2), rtol=0, atol=0)
    assert asked == [(3 * 8 * 8, 8, 4 * 16, 2, 2)]
    assert len(launched) == int(taken)


def _step_spans(cfg):
    """Spans a train step opens, and the routed calls its hooks see: every
    f32 kernel-4 Conv2d forward and every transposed conv whose input
    carries a gradient, by network."""
    state = TI.create_state(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = collections.Counter()

    def hook(net):
        def f(mod, args):
            x = args[0]
            if x.dtype != torch.float32:
                return
            if isinstance(mod, ConvTranspose2d):
                seen[net] += int(torch.is_grad_enabled() and x.requires_grad)
            elif mod.kernel_size == (4, 4):
                seen[net] += 1
        return f

    for net in ("G", "P", "D", "F", "vgg"):
        for m in getattr(state, net).modules():
            if isinstance(m, (Conv2d, ConvTranspose2d)):
                m.register_forward_pre_hook(hook(net))
    step = TI.make_train_step(cfg, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, tiny_batch(3, b=cfg.batch_size))
    spans = sum(e.name == SPAN for e in prof.events())
    return spans, seen


def test_hand_calls_per_step_256_f32(card_gate):
    spans, seen = _step_spans(Config(**TINY, batch_size=2))
    # one span a routed call: the forwards and the transposed convs' input
    # gradients; netD and netF four forwards a step, G and P one
    assert spans == sum(seen.values())
    assert seen["vgg"] == 0
    n_d = sum(1 for m in TI.build_discriminators(Config(**TINY)).D.modules()
              if isinstance(m, Conv2d))
    assert seen["D"] == 4 * n_d and seen["F"] == 4 * 3


def test_hand_calls_per_step_512_bf16(card_gate):
    spans, seen = _step_spans(Config(**TINY, batch_size=2, dtype="bfloat16",
                                     remat=True, remat_depth=1))
    # the bf16 U-Nets route nothing; netD and netF stay f32 and route
    assert seen["G"] == seen["P"] == seen["vgg"] == 0
    assert spans == seen["D"] + seen["F"] > 0


@pytest.mark.parametrize("px, nets, calls", [(256, "GPDF", 55),
                                             (512, "DF", 12)])
def test_hand_calls_per_step_at_full_width(px, nets, calls):
    """The count conv.hand_calls_per_step reads in the train cells (batch
    8): the same calls a step as above, each kept where conv_cuda.takes
    its full-width shape."""
    assert hand_calls_per_step(px, 8, nets) == calls


@pytest.mark.parametrize("batch, calls", [(1, 16), (8, 13)])
def test_hand_calls_per_serving_call_at_full_width(batch, calls):
    """The launches chip_smoke.py holds a 256 px serving call to: the
    U-Nets' kernel-4 down convs that conv_cuda.takes at the call's batch
    (no input gradient without a graph)."""
    assert hand_calls_per_forward(256, batch) == calls
