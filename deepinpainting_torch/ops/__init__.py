"""Tensor ops: mask math, torch-geometry layers, int8 convolutions, IPSR
attention and its CUDA scan kernel."""

from .masks import (HOLE_FILL_RGB, center_mask, draw_strokes, expand_mask,
                    feat_mask, fill_hole_with_mean, patch_flags,
                    random_stroke_mask, render_strokes, zero_hole)
