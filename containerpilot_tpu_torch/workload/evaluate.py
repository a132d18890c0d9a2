"""Standalone evaluation: checkpoint + token shards -> loss/perplexity
(counterpart of ``containerpilot_tpu/workload/evaluate.py``).

Scores the latest checkpoint of a trainer run (the raw params, or the
EMA shadow with ``--use-ema``) over a dataset's held-out windows (or the
training stream from its head with ``--eval-holdout 0 --max-batches
N``) and prints one JSON line:

    python -m containerpilot_tpu_torch.workload.evaluate \\
        --checkpoint-dir /ckpt --data-dir /data --eval-holdout 64 \\
        --d-model 1024 ...   (model flags must match the checkpoint)

``--eval-holdout`` is required and must equal the trainer's value. The
loss is ``modelcfg.average_eval_loss``, the trainer's in-loop eval, so
the numbers are comparable by construction. Only the params leave disk
(the checkpoint is memory-mapped). ``--lora-dir``/``--lora-rank``,
``--window`` and ``--moe-experts`` are not ported yet and exit.
"""
from __future__ import annotations

import argparse
import json
import math


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-kv-heads", type=int, default=0)
    parser.add_argument("--vocab", type=int, default=32_000)
    parser.add_argument("--loss-chunk", type=int, default=0)
    parser.add_argument(
        "--eval-holdout", type=int, required=True,
        help="score the dataset's LAST N windows; MUST equal the trainer's "
        "--eval-holdout (0 = score the training stream from its head)",
    )
    parser.add_argument("--max-batches", type=int, default=0,
                        help="cap scored batches (0 = the whole split)")
    parser.add_argument("--use-ema", action="store_true",
                        help="score the checkpoint's EMA shadow weights")
    not_ported = parser.add_argument_group(
        "reference flags not ported yet (any value but the default exits)"
    )
    not_ported.add_argument("--window", type=int, default=0)
    not_ported.add_argument("--moe-experts", type=int, default=0)
    not_ported.add_argument("--lora-dir", default="")
    not_ported.add_argument("--lora-rank", type=int, default=0)
    args = parser.parse_args(argv)
    for flag, value, default in (
        ("--window", args.window, 0), ("--moe-experts", args.moe_experts, 0),
        ("--lora-dir", args.lora_dir, ""), ("--lora-rank", args.lora_rank, 0),
    ):
        if value != default:
            raise SystemExit(
                f"{flag} is not ported yet to the PyTorch/CUDA evaluator "
                "(see ROADMAP.md)"
            )

    from .. import resolve_device
    from ..models.transformer import TransformerConfig
    from ..parallel import abstract_train_state, restore_params
    from .data import TokenShardDataset
    from .modelcfg import average_eval_loss, derive_d_ff

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=derive_d_ff(args.d_model),
        max_seq_len=args.seq_len,
        loss_chunk=args.loss_chunk,
    )
    restored = restore_params(
        args.checkpoint_dir, abstract_train_state(cfg),
        prefer_ema=args.use_ema, device=device,
    )
    if restored is None:
        raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
    params, step = restored

    dataset = TokenShardDataset(
        args.data_dir, args.seq_len, args.batch,
        vocab_size=cfg.vocab_size, holdout_windows=args.eval_holdout,
    )
    if args.eval_holdout > 0:
        n, batch_at = dataset.n_eval_batches, dataset.eval_batch
    else:
        n, batch_at = dataset.n_windows // args.batch, dataset.batch_at
    if args.max_batches > 0:
        n = min(n, args.max_batches)
    if n < 1:
        raise SystemExit("dataset yields no full eval batch at this "
                         "batch/seq-len; shrink --batch or --seq-len")

    loss = average_eval_loss(params, cfg, n, batch_at)
    print(json.dumps({
        "checkpoint_step": int(step),
        "eval_loss": round(loss, 6),
        "perplexity": round(math.exp(loss), 4),
        "batches": n,
        "tokens": n * args.batch * args.seq_len,
        "split": "holdout" if args.eval_holdout > 0 else "head",
        "ema": restored.ema,
        "lora": False,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
