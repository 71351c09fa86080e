"""Global configuration (counterpart of ``nifty_tpu/config.py``).

``hartley_convention``: ``"canonical_hartley"`` (H = Re F − Im F, the
default) or ``"non_canonical_hartley"`` (Re F + Im F).  Kept for the
configuration API only: no code reads it, here or in the JAX package, so
the port's Hartley is always the canonical one.  Kernel dispatch follows
the device of the tensor, not a configuration key.
"""

from __future__ import annotations

_config = {"hartley_convention": "canonical_hartley"}

_VALID = {"hartley_convention": ("canonical_hartley", "non_canonical_hartley")}

__all__ = ["update"]


def update(key: str, value) -> None:
    """Validated update of a global configuration value."""
    if key not in _config:
        raise KeyError(f"unknown config key {key!r}; known: {sorted(_config)}")
    if value not in _VALID[key]:
        raise ValueError(f"{key!r} must be one of {_VALID[key]}; got {value!r}")
    _config[key] = value
