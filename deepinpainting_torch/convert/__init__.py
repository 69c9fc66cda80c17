"""Weight converters: the bridge from the JAX package's flat .npz exports
(`jax_bridge`), reference checkpoints (`net_import`) and torchvision's VGG16
(`vgg_import`)."""

from .net_import import (load_torch_module, torch_module_to_state_dict,
                         torch_state_dict_to_module)
from .vgg_import import convert_vgg16_state_dict, torch_file_to_npz
