"""The jax-free flag and request helpers the server needs (copies of
``containerpilot_tpu/workload/modelcfg.py``'s ``derive_d_ff``,
``parse_logit_bias`` and ``parse_stop_ids``; the port keeps its own)."""
from __future__ import annotations

from typing import Any

from ..models.decode import BIAS_SLOTS_MAX


def derive_d_ff(d_model: int) -> int:
    """The shared SwiGLU width rule: ~3x d_model, floored to a 128
    multiple, never 0."""
    return d_model * 3 // 128 * 128 or 128


def parse_logit_bias(raw: Any, vocab_size: int):
    """OpenAI's {token_id: bias} with string or int keys; ``{}`` and None
    are a no-op. Raises ValueError for the 422 path."""
    if raw is None:
        return None
    if not isinstance(raw, dict):
        raise ValueError("'logit_bias' must be a {token_id: bias} object")
    if not raw:
        return None
    if len(raw) > BIAS_SLOTS_MAX:
        raise ValueError(f"'logit_bias' is capped at {BIAS_SLOTS_MAX} tokens")
    out = {}
    for k, v in raw.items():
        try:
            tok = int(k)
            bias = float(v)
        except (TypeError, ValueError):
            raise ValueError(
                "'logit_bias' keys must be token ids and values numbers"
            ) from None
        if not 0 <= tok < vocab_size:
            raise ValueError(
                f"'logit_bias' token ids must be in [0, {vocab_size})"
            )
        if not abs(bias) <= 100:
            raise ValueError("'logit_bias' values must be in [-100, 100]")
        out[tok] = bias
    return out


def parse_stop_ids(raw: Any, vocab_size: int):
    """A list of at most 8 non-empty id rows (1..32 ids each). Raises
    ValueError for the 422 path."""
    if raw is None:
        return []
    if not isinstance(raw, list) or len(raw) > 8 or not all(
        isinstance(s, list)
        and 1 <= len(s) <= 32
        and all(
            isinstance(t, int) and not isinstance(t, bool)
            and 0 <= t < vocab_size
            for t in s
        )
        for s in raw
    ):
        raise ValueError(
            "'stop' must be a list of at most 8 sequences, each "
            f"1..32 token ids in [0, {vocab_size})"
        )
    return raw
