"""Group-composed YAML configs (a light replacement for Hydra).

The port's copy of ``nabladft_tpu/config.py``, reading the same
``configs/*.yaml``:

  * a top-level YAML may declare ``defaults: {group: name, ...}``; each
    group resolves to ``<config_dir>/<group>/<name>.yaml`` and is merged
    under the ``group`` key (explicit keys in the top-level file win);
  * string values of the form ``${key.path}`` are interpolated from the
    merged config.

PyYAML is imported only by `load_config`: code that builds its config as a
dict (`compose`) runs without it.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Dict, Optional

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_INLINE = re.compile(r"\$\{([^}]+)\}")


def _deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _lookup(cfg: Dict, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _interpolate(node: Any, root: Dict) -> Any:
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:
            return _lookup(root, m.group(1))
        return _INTERP_INLINE.sub(lambda m: str(_lookup(root, m.group(1))), node)
    return node


def load_config(
    path: Path,
    overrides: Optional[Dict[str, Any]] = None,
    config_dir: Optional[Path] = None,
) -> Dict[str, Any]:
    import yaml

    path = Path(path)
    config_dir = Path(config_dir) if config_dir else path.parent
    cfg = yaml.safe_load(path.read_text()) or {}
    defaults = cfg.pop("defaults", {}) or {}
    for group, name in defaults.items():
        group_file = config_dir / group / f"{name}.yaml"
        group_cfg = yaml.safe_load(group_file.read_text()) or {}
        cfg[group] = _deep_merge(group_cfg, cfg.get(group, {}))
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    # two interpolation passes so group values can reference interpolated scalars
    cfg = _interpolate(cfg, cfg)
    cfg = _interpolate(cfg, cfg)
    return cfg


def compose(base: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """Merge dict overrides into a config (for programmatic composition)."""
    merged = _deep_merge(base, overrides)
    return _interpolate(merged, merged)
