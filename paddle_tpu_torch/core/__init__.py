from . import initializers
from .device import resolve_device
from .dtypes import (Policy, bfloat16_compute, canonicalize, current_policy,
                     float32, use_policy)

__all__ = ["Policy", "bfloat16_compute", "canonicalize", "current_policy",
           "float32", "initializers", "resolve_device", "use_policy"]
