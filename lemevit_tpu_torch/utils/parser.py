"""Two-stage config parsing: ``--config FILE`` sets argparse defaults, the
command line overrides them; counterpart of lemevit_tpu/utils/parser.py.

The config files of this repository (configs/*.yaml) are flat mappings of
scalars, which ``load_flat_yaml`` reads without a YAML package: one
``key: value`` per line, ``#`` comments, values as YAML reads them (ints,
floats, true / false, null, quoted or bare strings, flow lists ``[a, b]``).
Anything nested raises. Returns (args, args_text), the text a flat YAML
dump of the resolved arguments (args.yaml, for the run's record).
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Any, Dict, Optional, Sequence, Tuple

_INT = re.compile(r"[-+]?\d+")
_FLOAT = re.compile(r"[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?")


def _scalar(text: str) -> Any:
    t = text.strip()
    if t in ("", "~", "null", "Null", "NULL"):
        return None
    if t in ("true", "True", "TRUE"):
        return True
    if t in ("false", "False", "FALSE"):
        return False
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if _INT.fullmatch(t):
        return int(t)
    if _FLOAT.fullmatch(t):
        return float(t)
    return t


def load_flat_yaml(path: str) -> Dict[str, Any]:
    """Read a flat ``key: value`` YAML file (see the module docstring)."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for no, line in enumerate(f, 1):
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            body = line.split(" #")[0].rstrip()
            key, sep, value = body.partition(":")
            if not sep or line[0].isspace() or not key.strip():
                raise ValueError(f"{path}:{no}: expected a flat "
                                 f"'key: value' line, got {line.rstrip()!r}")
            value = value.strip()
            if value.startswith("[") and value.endswith("]"):
                inner = value[1:-1].strip()
                out[key.strip()] = ([_scalar(v) for v in inner.split(",")]
                                    if inner else [])
            elif value[:1] in ("{", "|", ">", "&", "*") or value == "":
                raise ValueError(f"{path}:{no}: nested or block values are "
                                 "not supported in a flat config")
            else:
                out[key.strip()] = _scalar(value)
    return out


def parse_args_with_config(
    parser: argparse.ArgumentParser,
    argv: Optional[Sequence[str]] = None,
) -> Tuple[argparse.Namespace, str]:
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default=None, metavar="FILE")
    cfg_args, remaining = config_parser.parse_known_args(argv)
    if cfg_args.config:
        cfg = load_flat_yaml(cfg_args.config)
        known = {a.dest for a in parser._actions}
        unknown = set(cfg) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        parser.set_defaults(**cfg)
    args = parser.parse_args(remaining)
    args.config = cfg_args.config
    text = "".join(f"{k}: {json.dumps(v)}\n"
                   for k, v in sorted(vars(args).items()))
    return args, text
