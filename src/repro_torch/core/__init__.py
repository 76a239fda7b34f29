"""INT-FP-QSim core in PyTorch: formats, quantizers, ABFP, policy, qmatmul."""

from repro_torch.core import formats
from repro_torch.core.formats import get_format
from repro_torch.core.policy import (
    Policy,
    PolicyMap,
    PolicyRule,
    QuantPolicy,
    TensorQuant,
    as_policy_map,
    policy_from_dict,
    policy_to_dict,
    preset,
    resolve_policy,
)

__all__ = [
    "formats", "get_format", "Policy", "PolicyMap", "PolicyRule",
    "QuantPolicy", "TensorQuant", "as_policy_map", "policy_from_dict",
    "policy_to_dict", "preset", "resolve_policy",
]
