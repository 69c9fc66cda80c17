"""Inference engine: model factory, init and the two-stage forward."""

from .inpaint import (Models, build_models, init_params, make_inference_fn,
                      make_serving_fn, two_stage_forward)

__all__ = ["Models", "build_models", "init_params", "make_inference_fn",
           "make_serving_fn", "two_stage_forward"]
