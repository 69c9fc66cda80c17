"""A whole run of each kind of cell, on the CPU at a tiny size, past the
harness's look for a card: sound, it is correct; with the timed path
broken underneath, `correct` comes out false, once for each fault the cell
can have (one chip: no exchange between chips to leave out)."""

import pytest
import torch

from conftest import OPEN_LOOP, TINY, tiny_cell
from portbench import harness

SEED = 2**31 + 77


def _run(name, seconds=1.0):
    return harness.run_cell(tiny_cell(name), SEED, seconds, False, "cpu",
                            cfg_override=TINY)


@pytest.mark.parametrize("name", ["train-256-f32", "serve-256-f32-sat",
                                  OPEN_LOOP])
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


# ---- train ------------------------------------------------------------------

def _wrap_train_step(monkeypatch, wrap):
    from deepinpainting_torch.engine import inpaint as TI
    real = TI.make_train_step
    monkeypatch.setattr(TI, "make_train_step",
                        lambda cfg, dev=None, group=None:
                        wrap(real(cfg, dev, group)))


def test_train_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None:
                        None)
    r = _run("train-256-f32")
    assert not r["correct"]
    assert r["checks"]["delta3.worst_leaf"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out(monkeypatch):
    def wrap(step):
        return lambda state, batch, generator=None: step(
            state, {k: v[:len(v) // 2] for k, v in batch.items()}, generator)
    _wrap_train_step(monkeypatch, wrap)
    assert not _run("train-256-f32")["correct"]


def test_train_loss_altered_where_produced(monkeypatch):
    def wrap(step):
        def altered(state, batch, generator=None):
            state, m = step(state, batch, generator)
            return state, dict(m, G_L1=m["G_L1"] * 1.01)
        return altered
    _wrap_train_step(monkeypatch, wrap)
    r = _run("train-256-f32")
    assert not r["correct"]
    assert r["checks"]["loss.step1.G"]["value"] > 5e-3


# ---- serve ------------------------------------------------------------------

def _wrap_serving(monkeypatch, wrap):
    from deepinpainting_torch.serve import app
    real = app.make_serving_fn
    monkeypatch.setattr(app, "make_serving_fn",
                        lambda cfg, device=None, group=None:
                        wrap(real(cfg, device, group)))


@pytest.mark.parametrize("name", ["serve-256-f32-sat", OPEN_LOOP])
def test_serve_half_of_the_batch_left_out(monkeypatch, name):
    """The coalesced call computes the first half of its rows; the rest
    get the first row's answer."""
    calls = []

    def wrap(fn):
        def half(G, P, vgg, image, mask, ref):
            keep = max(1, len(image) - len(image) // 2)
            out = fn(G, P, vgg, image[:keep], mask[:keep], ref[:keep])
            calls.append(len(image))
            return torch.cat([out, out[:1].expand(len(image) - keep,
                                                  *out.shape[1:])])
        return half
    _wrap_serving(monkeypatch, wrap)
    r = _run(name, seconds=2.0)
    assert max(calls) > 1, "no call coalesced two requests"
    assert not r["correct"]


def test_serve_answer_altered_where_produced(monkeypatch):
    """The answers come back quantised 2 levels off (a changed offset
    where the uint8 image is made)."""
    def wrap(fn):
        def altered(G, P, vgg, image, mask, ref):
            out = fn(G, P, vgg, image, mask, ref)
            return torch.clamp(out.int() + 2, 0, 255).to(torch.uint8)
        return altered
    _wrap_serving(monkeypatch, wrap)
    r = _run("serve-256-f32-sat")
    assert not r["correct"]
    assert r["checks"]["u8.mean_levels"]["value"] > 1.5


def test_serve_request_that_fails_is_counted(monkeypatch):
    """Every third serving call after the set-up's eight raises."""
    def wrap(fn):
        calls = []

        def failing(G, P, vgg, image, mask, ref):
            calls.append(len(image))
            if len(calls) > 8 and len(calls) % 3 == 0:
                raise RuntimeError("planted failure")
            return fn(G, P, vgg, image, mask, ref)
        return failing
    _wrap_serving(monkeypatch, wrap)
    r = _run(OPEN_LOOP)
    assert r["failed"] > 0 and not r["correct"]
