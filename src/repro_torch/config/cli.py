"""Tiny CLI override layer: ``--arch smollm-360m --set sync.period=4``.
Copied from ``repro.config.cli``; a comma-separated value is a tuple
(``--set sync.adapt_ladder=1,2,4``), which the reference's layer passes on
as a string that its tuple fields then refuse."""
from __future__ import annotations

import argparse
from typing import Any, Sequence

from repro_torch.config.base import TrainConfig, replace


def _coerce(value: str) -> Any:
    if "," in value:
        return tuple(_coerce(v) for v in value.split(",") if v)
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def apply_overrides(cfg: TrainConfig, overrides: Sequence[str]) -> TrainConfig:
    kw = {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, value = item.split("=", 1)
        kw[key] = _coerce(value)
    return replace(cfg, **kw) if kw else cfg


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--arch", default="smollm-360m", help="architecture id")
    p.add_argument("--shape", default="train_4k",
                   help="input shape cell: train_4k|prefill_32k|decode_32k|long_500k|smoke")
    p.add_argument("--multi-pod", action="store_true", help="use the 2x16x16 mesh")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override")
    return p
