"""Shared CLI argument handling: one flag per ``Config`` field, mapped onto
the dataclass (the port's own copy of ``snipper_tpu/cli/common.py:53-128``)."""

from __future__ import annotations

import argparse
import dataclasses

from snipper_tpu_torch.config import PRESETS, Config


def _strict_bool(s: str) -> bool:
    """Reject unrecognized values: ``--aux_loss yes`` silently parsing as
    False would disable a loss with no error."""
    if s in ("1", "true", "True"):
        return True
    if s in ("0", "false", "False"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected true/false/1/0 (got {s!r})")


def add_config_args(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(Config):
        if f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=None)
        elif f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=_strict_bool,
                                default=None)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=None)


def build_config(args) -> Config:
    if args.preset:
        if args.preset not in PRESETS:
            raise SystemExit(f"unknown preset {args.preset!r}; choose from: "
                             f"{', '.join(PRESETS)}")
        cfg = getattr(Config, args.preset)()
    else:
        cfg = Config()
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    try:
        return cfg.replace(**overrides).validate()
    except ValueError as e:
        raise SystemExit(str(e)) from e
