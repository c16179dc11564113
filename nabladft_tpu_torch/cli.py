"""Command-line entry: ``python -m nabladft_tpu_torch.cli --config <file> [k=v ...]``.

Overrides use dotted keys: ``job_type=predict datamodule.source=<db>
output_db=<out>``. Runs on the card unless ``--device`` names another.
Needs PyYAML (configs and override values are YAML).
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
from pathlib import Path
from typing import Any, Dict

from nabladft_tpu_torch.config import load_config
from nabladft_tpu_torch.pipelines import run

_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_overrides(pairs) -> Dict[str, Any]:
    import yaml

    out: Dict[str, Any] = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        value = yaml.safe_load(raw)
        # YAML 1.1 leaves '1e-3' (no dot) as a string — users mean a float
        if isinstance(value, str) and _FLOAT_RE.match(value):
            value = float(value)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="nablaDFT PyTorch pipeline runner")
    parser.add_argument("--config", required=True, type=Path)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    cfg = load_config(args.config, overrides=_parse_overrides(args.overrides))
    run(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
