"""Byte-level tokenizer: text in/out for the serving API with zero
external dependencies (the port's own copy of
``containerpilot_tpu/workload/text.py``: the same prompt encodes to the
same ids on a JAX and a torch replica).

The framework's API is token-level by design (tokenization is the
caller's concern — workload/serve.py); this adapter gives any model
with ``vocab_size >= 259`` a text surface: UTF-8 bytes map to ids
3..258 with pad/bos/eos at 0/1/2. Byte-level means no vocabulary
file, no external assets, and perfect reversibility — the ByT5/byte-LM
recipe. Serve exposes it as ``POST /v1/completions`` behind ``--text``.
"""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    PAD = 0
    BOS = 1
    EOS = 2
    OFFSET = 3
    N_IDS = 259  # 3 specials + 256 byte values

    def __init__(self, vocab_size: int) -> None:
        if vocab_size < self.N_IDS:
            raise ValueError(
                f"byte tokenizer needs vocab_size >= {self.N_IDS}, "
                f"got {vocab_size}"
            )
        self.vocab_size = vocab_size

    def encode(self, text: str, bos: bool = True) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return [self.BOS] + ids if bos else ids

    def to_bytes(self, ids: List[int]) -> bytes:
        """The raw bytes behind a run of ids: specials and
        out-of-byte-range ids (a model may emit any id < vocab_size)
        are dropped. The ONE id filter — decode() and the streaming
        surface both read through it, so their outputs can't drift."""
        return bytes(
            i - self.OFFSET
            for i in ids
            if self.OFFSET <= i < self.OFFSET + 256
        )

    def decode(self, ids: List[int]) -> str:
        """Ids back to text; invalid UTF-8 sequences become
        replacement characters."""
        return self.to_bytes(ids).decode("utf-8", errors="replace")


def stream_decoder(tokenizer: ByteTokenizer):
    """(delta_event, tail_events) for SSE text streaming with UTF-8
    partial-byte holdback: the byte tokenizer can split a multibyte
    character across chunk boundaries, so an incremental decoder
    buffers dangling bytes between events and the tail flush emits
    whatever remains (replacement chars — exactly what decode() does
    to the same ids). Incremental UTF-8 decoding is split-invariant,
    so concatenated event text equals decode() of the concatenated
    ids for EVERY possible chunking."""
    import codecs

    dec = codecs.getincrementaldecoder("utf-8")("replace")

    def delta_event(delta: List[int]) -> dict:
        return {
            "tokens": delta,
            "text": dec.decode(tokenizer.to_bytes(delta)),
        }

    def tail_events() -> List[dict]:
        flush = dec.decode(b"", True)
        return [{"tokens": [], "text": flush}] if flush else []

    return delta_event, tail_events
