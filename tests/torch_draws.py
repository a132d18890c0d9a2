"""Helpers of the sampled-parity tests: hold the port's sampled tokens to
the reference's, and where a token differs, report how near a tie the
draw was (the gap between the top two perturbed scores: torch's and
XLA's ``log`` can round an ulp apart, which flips only a draw that
close)."""
import torch

from containerpilot_tpu_torch.models import decode as tdecode
from containerpilot_tpu_torch.ops import prng


def first_difference(ref_rows, got_rows):
    """(row, step) of the first token that differs, or None."""
    for r, (a, b) in enumerate(zip(ref_rows, got_rows)):
        for i, (x, y) in enumerate(zip(a, b)):
            if int(x) != int(y):
                return r, i
        if len(a) != len(b):
            return r, min(len(a), len(b))
    return None


def perturbed_gap(logits, row_key, step, temperature=1.0, top_k=0,
                  top_p=0.0) -> float:
    """The gap between the top two perturbed scores of the draw of
    ``step`` from ``row_key`` ([2]) over one row of ``logits``."""
    x = tdecode.filter_logits(
        logits.reshape(1, -1), torch.tensor([temperature]),
        torch.tensor([top_k]), torch.tensor([top_p]))[0]
    noise = prng.gumbel(prng.fold_in(row_key, step), (x.shape[0],))
    top = torch.topk(noise + x, 2).values
    return float(top[0] - top[1])


def _logits_after(params, cfg, prompt, emitted):
    """The port's next-token logits [vocab] after ``prompt`` and the
    ``emitted`` tokens (a one-shot prefill: quantized params too)."""
    seq = torch.tensor([list(prompt) + [int(t) for t in emitted]])
    with torch.inference_mode():
        logits, _cache = tdecode.prefill(params, seq, cfg, seq.shape[1])
    return logits[0].float()


def teacher_forced_gap(params, cfg, prompt, emitted, step, row_key,
                       **knobs) -> float:
    """``perturbed_gap`` at ``step`` of a row whose first ``step``
    tokens were ``emitted`` after ``prompt`` (the port's logits there;
    penalties and logit_bias left out)."""
    logits = _logits_after(params, cfg, prompt, emitted[:step])
    return perturbed_gap(logits, row_key, step, **knobs)


def assert_same_tokens(ref_rows, got_rows, gap_at=None):
    """``got_rows`` must equal ``ref_rows``; on a difference the message
    carries ``gap_at(row, step)``, the draw's top-two gap there."""
    ref_rows = [[int(t) for t in row] for row in ref_rows]
    got_rows = [[int(t) for t in row] for row in got_rows]
    where = first_difference(ref_rows, got_rows)
    if where is None:
        return
    gap = gap_at(*where) if gap_at is not None else "not computed"
    raise AssertionError(
        f"sampled tokens differ at row {where[0]} step {where[1]}: "
        f"reference {ref_rows[where[0]]}, port {got_rows[where[0]]}; "
        f"top-two perturbed score gap there {gap}")
