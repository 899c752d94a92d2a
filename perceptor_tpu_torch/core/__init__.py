from perceptor_tpu_torch.core.pytree import Functional, field, static_field
from perceptor_tpu_torch.core.dtypes import Policy, default_policy, half_policy
from perceptor_tpu_torch.core.shapes import assert_shape, assert_dims
from perceptor_tpu_torch.core.init import init_on_cpu

__all__ = [
    "Functional",
    "field",
    "static_field",
    "Policy",
    "default_policy",
    "half_policy",
    "assert_shape",
    "assert_dims",
    "init_on_cpu",
]
