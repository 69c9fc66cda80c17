"""The engine: model factory, init, the two-stage forward, the inference
and serving functions, the training state, the train and eval steps.  The
epoch trainer, the evaluator and checkpoints are the modules trainer.py,
evaluator.py and checkpoint.py."""

from .inpaint import (Discriminators, Models, build_discriminators,
                      build_models, create_state, init_discriminators,
                      init_params, make_coarse_fn, make_eval_step,
                      make_inference_fn, make_serving_fn, make_train_step,
                      two_stage_forward)
from .state import (TrainState, create_train_state, current_learning_rate,
                    set_learning_rate)

__all__ = ["Discriminators", "Models", "TrainState", "build_discriminators",
           "build_models", "create_state", "create_train_state",
           "current_learning_rate", "init_discriminators", "init_params",
           "make_coarse_fn", "make_eval_step", "make_inference_fn",
           "make_serving_fn", "make_train_step", "set_learning_rate",
           "two_stage_forward"]
