"""Model zoo: the 10 assigned architectures as one configurable family set."""
from repro_torch.models.api import Model, get_model
from repro_torch.models.common import ModelConfig, init_params, params_from_numpy

__all__ = ["Model", "get_model", "ModelConfig", "init_params", "params_from_numpy"]
