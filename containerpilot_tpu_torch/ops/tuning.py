"""Flash-attention block choice and the flash/plain crossover, measured
per card and persisted (the port's counterpart of
``containerpilot_tpu/ops/tuning.py``).

The table is produced by ``python -m containerpilot_tpu_torch.ops.autotune
--write`` on the card itself (``ops/autotune.py``) and shipped per
platform under ``ops/tuned/<platform>.json``, in the reference's schema:

    {"platform": "nvidia-h100-80gb-hbm3",
     "flash_min_seq": {"train": 128, "fwd": 128},
     "blocks": {"train": {"1024": [128, 128], ...}, "fwd": {...}},
     "speedup_vs_default": {...}, "measurements": {...}}

Consumers:
- ``pick_blocks(kind, seq)`` -> (block_q, block_k) for the flash call
  (exact seq entry, else the nearest tuned seq at/below, else 128/128),
  clamped to divisors of seq. The port's kernels tile by their own 64
  whatever the pair, so their tables hold the default pair.
- ``auto_min_seq(kind)`` -> the measured crossover: shorter sequences
  run faster through the plain ``causal_attention`` than through the
  flash kernels, so ``flash_min_seq: AUTO`` resolves here
  (``models/transformer.py`` ``flash_eligible``).

The platform follows the device the attention's tensors are on (the
model passes it): a card's name (``torch.cuda.get_device_name``), and
``cpu`` for a CPU tensor or where no card is present. No table is
shipped for ``cpu``, so a CPU run keeps the untuned defaults exactly
(128/128 blocks, crossover 1024) even on a host with a card, and never
asks CUDA for a name. The TPU's table describes another chip and is
never read. Override the table path with ``CONTAINERPILOT_FLASH_TABLE``;
``set_table(None)`` reverts to auto-discovery.
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, Optional, Tuple

log = logging.getLogger("containerpilot.tuning")

DEFAULT_BLOCK = 128
DEFAULT_MIN_SEQ = 1024  # untuned crossover default
AUTO = -1               # TransformerConfig.flash_min_seq sentinel

_TUNED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tuned")

# module state: a table installed by set_table (None: discover), and
# the discovered table of each platform (None where none is shipped)
_table: Optional[dict] = None
_discovered: Dict[str, Optional[dict]] = {}


def slug(device_name: str) -> str:
    """A device name as a file name: 'NVIDIA H100 80GB HBM3' ->
    'nvidia-h100-80gb-hbm3'."""
    return re.sub(r"[^a-z0-9]+", "-", device_name.lower()).strip("-")


def platform_slug(device="cuda") -> str:
    """The name of the card ``device`` names, as a slug; 'cpu' for a CPU
    device (CUDA left untouched) or where no card is present."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return slug(torch.cuda.get_device_name(dev))


def _table_path(device="cuda") -> Optional[str]:
    override = os.environ.get("CONTAINERPILOT_FLASH_TABLE")
    if override:
        return override
    path = os.path.join(_TUNED_DIR, f"{platform_slug(device)}.json")
    return path if os.path.exists(path) else None


def set_table(table: Optional[dict]) -> None:
    """Install a table dict for every device (tests, autotune); None
    reverts to on-disk auto-discovery at the next lookup."""
    global _table
    _table = table
    _discovered.clear()


def _get_table(device="cuda") -> Optional[dict]:
    if _table is not None:
        return _table
    path = _table_path(device)
    if path not in _discovered:
        _discovered[path] = None
        if path:
            try:
                with open(path) as fh:
                    _discovered[path] = json.load(fh)
                log.info("flash tuning table: %s", path)
            except (OSError, ValueError) as exc:
                log.warning("flash tuning table unreadable (%s): %s",
                            path, exc)
    return _discovered[path]


def _largest_divisor_block(seq: int, block: int) -> int:
    """The largest block <= ``block`` dividing seq (halving, floored at
    DEFAULT_BLOCK). Fails loudly on seq not a multiple of DEFAULT_BLOCK:
    every flash call site gates on flash_eligible."""
    if seq % DEFAULT_BLOCK != 0:
        raise ValueError(
            f"flash blocks require seq % {DEFAULT_BLOCK} == 0; got "
            f"seq={seq} (gate the call on flash_eligible)"
        )
    b = block
    while b > DEFAULT_BLOCK and seq % b != 0:
        b //= 2
    return max(b, DEFAULT_BLOCK)


def pick_blocks(kind: str, seq: int, device="cuda") -> Tuple[int, int]:
    """(block_q, block_k) for a flash call of ``kind`` ('train' = the
    differentiable fwd+bwd path, 'fwd' = inference/prefill) at ``seq``
    on ``device``."""
    bq, bk = DEFAULT_BLOCK, DEFAULT_BLOCK
    table = _get_table(device)
    if table is not None:
        entries: Dict[str, list] = table.get("blocks", {}).get(kind, {})
        tuned_seqs = sorted(int(s) for s in entries)
        at_or_below = [s for s in tuned_seqs if s <= seq]
        if at_or_below:
            bq, bk = entries[str(at_or_below[-1])]
    return _largest_divisor_block(seq, bq), _largest_divisor_block(seq, bk)


def auto_min_seq(kind: str = "train", device="cuda") -> int:
    """The measured crossover below which plain attention wins on
    ``device``; the untuned default when no table is shipped for its
    platform."""
    table = _get_table(device)
    if table is not None:
        value = table.get("flash_min_seq", {}).get(kind)
        if isinstance(value, int) and value >= 0:
            return value
    return DEFAULT_MIN_SEQ


def resolve_min_seq(configured: int, kind: str = "train",
                    device="cuda") -> int:
    """Map a TransformerConfig.flash_min_seq to an effective threshold:
    AUTO (-1) asks the tuned table of ``device``'s platform; explicit
    values win unchanged (0 keeps meaning 'never use flash')."""
    return auto_min_seq(kind, device) if configured == AUTO else configured
