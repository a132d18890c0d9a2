"""Flash-attention block choice and the flash/plain crossover.

The no-table half of ``containerpilot_tpu/ops/tuning.py``: there is no
measured H100 table yet, so every lookup answers the untuned defaults
(128/128 blocks, crossover 1024). The TPU's tuned table is never read —
its numbers describe another chip.
"""
from __future__ import annotations

from typing import Tuple

DEFAULT_BLOCK = 128
DEFAULT_MIN_SEQ = 1024  # untuned crossover default
AUTO = -1               # TransformerConfig.flash_min_seq sentinel


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


def pick_blocks(kind: str, seq: int) -> Tuple[int, int]:
    """(block_q, block_k) for a flash call of ``kind`` ('train' or
    'fwd') at ``seq``; the defaults until an H100 table is measured."""
    del kind  # no per-kind table yet
    return (
        _largest_divisor_block(seq, DEFAULT_BLOCK),
        _largest_divisor_block(seq, DEFAULT_BLOCK),
    )


def resolve_min_seq(configured: int, kind: str = "train") -> int:
    """Map a TransformerConfig.flash_min_seq to an effective threshold:
    AUTO (-1) takes the default crossover; explicit values win unchanged
    (0 keeps meaning 'never use flash')."""
    del kind
    return DEFAULT_MIN_SEQ if configured == AUTO else configured
