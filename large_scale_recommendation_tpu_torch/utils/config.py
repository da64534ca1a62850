"""Config composition (counterpart of
``large_scale_recommendation_tpu.utils.config``; framework-free, the same
code): overlays folded over a frozen config dataclass, later values winning.

    base = DSGDConfig(num_factors=64, iterations=10)
    cfg  = merge_config(base, {"iterations": 5}, seed=1)

Unknown keys fail loudly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


def merge_config(base: Any, *overlays: Mapping[str, Any] | Any, **kw: Any):
    """Fold overlays over ``base`` (a frozen config dataclass), later
    values winning. Overlays are dicts or config instances of the
    SAME type (an instance overlay replaces wholesale, like retraining
    with a fresh ParameterMap). Returns a new frozen instance; ``base`` is
    never mutated. Unknown keys raise ``ValueError``.
    """
    if not dataclasses.is_dataclass(base):
        raise TypeError(f"merge_config needs a config dataclass, "
                        f"got {type(base).__name__}")
    fields = {f.name for f in dataclasses.fields(base)}
    out = base
    for ov in overlays + ((kw,) if kw else ()):
        if dataclasses.is_dataclass(ov) and not isinstance(ov, type):
            if type(ov) is not type(base):
                raise TypeError(
                    f"cannot merge {type(ov).__name__} into "
                    f"{type(base).__name__}")
            out = ov  # wholesale replace, like a rebuilt ParameterMap
            continue
        unknown = set(ov) - fields
        if unknown:
            raise ValueError(
                f"unknown config key(s) {sorted(unknown)} for "
                f"{type(base).__name__}; have {sorted(fields)}")
        out = dataclasses.replace(out, **dict(ov))
    return out


def config_to_dict(cfg: Any) -> dict[str, Any]:
    """The full parameter map of a config instance (``asdict`` without
    recursing into array-valued fields, which configs here never hold)."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
