"""Runtime configuration for tensorframes_tpu_torch.

The knobs the ported verbs read — row-bucketing ladder and the default
partition count — plus the execution ``device``. The bucketing and
partition knobs can be overridden via environment variables (``TFTPU_*``);
every field can be set programmatically via :func:`configure`. The device
is chosen only in code: ``configure(device=...)``, or the ``device=``
argument every verb takes, which overrides the configured one for that
call.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


@dataclasses.dataclass
class Config:
    # map_rows lead-dim bucketing: pad the vmapped row count up to
    # min_bucket * 2**k (k <= max_bucket_doublings) so the per-shape
    # cache stays O(log n) across varying block sizes; padded rows are
    # sliced off. Only row-independent semantics pad — map_blocks
    # programs see the true block.
    min_bucket: int = _env_int("TFTPU_MIN_BUCKET", 8)
    max_bucket_doublings: int = _env_int("TFTPU_MAX_BUCKET_DOUBLINGS", 30)
    # Default number of blocks when partitioning un-blocked input.
    default_num_blocks: int = _env_int("TFTPU_DEFAULT_NUM_BLOCKS", 4)
    # Where verbs execute: "cuda" (the default) or "cpu". With no GPU
    # present, "cuda" raises at the verb call instead of running on the
    # CPU; the CPU is used only when asked for.
    device: str = "cuda"


_config = Config()


def get_config() -> Config:
    return _config


def configure(**kwargs) -> Config:
    """Update global config fields by keyword; returns the live config."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise AttributeError(f"No such config field: {k!r}")
        setattr(_config, k, v)
    return _config


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a verb runs on: the explicit ``device`` argument, else
    ``config.device``. A CUDA device with no GPU present is an error —
    execution never moves to the CPU unless the caller asked for it."""
    dev = torch.device(device if device is not None else _config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False (no GPU visible to this process). Pass device='cpu' to the "
            "verb, or configure(device='cpu'), to run on the CPU."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
