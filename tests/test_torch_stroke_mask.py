"""Port vs JAX: ops/masks.py::random_stroke_mask.

torch cannot draw jax.random's numbers, so the port splits the function:
`draw_strokes` draws starts, deltas and lengths from a torch.Generator and
is held to its shapes, ranges and dtype; `render_strokes` turns draws into
the mask and is held against the JAX function on JAX's own draws (the
test recomputes them as the JAX function does, with jax.random.split and
uniform).  Both packages compute the distances in f32 with the same
operations; a pixel may differ only where its distance lies within 1e-6
of the radius, and each case counts those pixels (none so far).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepinpainting_tpu.ops import masks as JM
from deepinpainting_torch import ops as TO
from deepinpainting_torch.ops import masks as TM


def _jax_draws(key, num_strokes):
    """The draws of JM.random_stroke_mask, recomputed as it draws them."""
    k1, k2, k3 = jax.random.split(key, 3)
    starts = jax.random.uniform(k1, (num_strokes, 2), minval=0.1, maxval=0.9)
    deltas = jax.random.uniform(k2, (num_strokes, 2), minval=-1.0,
                                maxval=1.0)
    lengths = jax.random.uniform(k3, (num_strokes, 1), minval=0.2,
                                 maxval=1.0)
    return starts, deltas, lengths


def _distance_to_strokes(starts, deltas, lengths, fine_size, max_len):
    """Each pixel's distance to its nearest segment, in f64 (numpy)."""
    s, d, ln = (np.asarray(a, np.float64) for a in (starts, deltas, lengths))
    d = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-8)
    ends = np.clip(s + d * ln * (max_len / fine_size), 0.0, 1.0)
    yy = np.arange(fine_size) / (fine_size - 1)
    grid = np.stack(np.meshgrid(yy, yy, indexing="ij"), -1)[None]
    p0, v = s[:, None, None], (ends - s)[:, None, None]
    t = np.clip(((grid - p0) * v).sum(-1) / ((v * v).sum(-1) + 1e-12), 0, 1)
    return np.linalg.norm(grid - (p0 + t[..., None] * v), axis=-1).min(0)


@pytest.mark.parametrize("fine_size,num_strokes,max_len,thickness", [
    (64, 8, 48, 8), (128, 8, 48, 8), (256, 8, 48, 8), (512, 8, 48, 8),
    (256, 3, 96, 20), (100, 12, 30, 3)])
def test_render_equals_jax_on_jax_draws(fine_size, num_strokes, max_len,
                                        thickness):
    boundary_total = 0
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JM.random_stroke_mask(key, fine_size, num_strokes,
                                                max_len, thickness))
        draws = [torch.from_numpy(np.array(a))
                 for a in _jax_draws(key, num_strokes)]
        got = TM.render_strokes(*draws, fine_size, max_len, thickness)
        assert got.dtype == torch.float32
        assert got.shape == (fine_size, fine_size)
        got = got.numpy()
        differ = got != want
        if differ.any():
            dist = _distance_to_strokes(*draws, fine_size, max_len)
            radius = thickness / (2.0 * fine_size)
            assert (np.abs(dist[differ] - radius) <= 1e-6).all()
        boundary_total += int(differ.sum())
        assert 0 < want.mean() < 0.5
    assert boundary_total == 0, f"{boundary_total} boundary pixels differ"


def test_draws_have_jax_shapes_ranges_and_dtype():
    gen = torch.Generator().manual_seed(3)
    for n in (1, 8, 500):
        starts, deltas, lengths = TM.draw_strokes(gen, n)
        assert starts.shape == deltas.shape == (n, 2)
        assert lengths.shape == (n, 1)
        for t, lo, hi in ((starts, 0.1, 0.9), (deltas, -1.0, 1.0),
                          (lengths, 0.2, 1.0)):
            assert t.dtype == torch.float32
            assert float(t.min()) >= lo and float(t.max()) <= hi
    # wide enough draws cover most of each range
    assert float(starts.min()) < 0.12 and float(starts.max()) > 0.88
    assert float(deltas.min()) < -0.95 and float(deltas.max()) > 0.95


def test_random_stroke_mask_renders_its_draws():
    """random_stroke_mask is render_strokes of draw_strokes from the same
    generator state; the same seed repeats it, another seed does not."""
    mask = TO.random_stroke_mask(torch.Generator().manual_seed(5), 128)
    draws = TM.draw_strokes(torch.Generator().manual_seed(5), 8)
    assert torch.equal(mask, TM.render_strokes(*draws, 128))
    assert mask.shape == (128, 128) and mask.dtype == torch.float32
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}
    assert 0 < float(mask.mean()) < 0.5      # the JAX package's own check
    assert torch.equal(mask, TO.random_stroke_mask(
        torch.Generator().manual_seed(5), 128))
    assert not torch.equal(mask, TO.random_stroke_mask(
        torch.Generator().manual_seed(6), 128))


def test_batched_masks_feed_the_inference_mask_path():
    """A batch of stroke masks (as the JAX package's 512 px batched
    configuration vmaps them) equals JAX's, and so do their feature
    masks."""
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    want = np.asarray(jax.vmap(lambda k: JM.random_stroke_mask(k, 256))(keys))
    got = torch.stack([TM.render_strokes(
        *(torch.from_numpy(np.array(a)) for a in _jax_draws(k, 8)), 256)
        for k in keys])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TM.feat_mask(got).numpy(),
        np.asarray(jax.vmap(JM.feat_mask)(jnp.asarray(want))))
