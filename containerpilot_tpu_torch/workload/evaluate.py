"""Standalone evaluation: checkpoint + token shards -> loss/perplexity
(counterpart of ``containerpilot_tpu/workload/evaluate.py``).

Scores the latest checkpoint of a trainer run (the raw params, the EMA
shadow with ``--use-ema``, or a LoRA-adapted base with ``--lora-dir``
and ``--lora-rank``: the adapter merged into the checkpoint's params)
over a dataset's held-out windows (or the training stream from its head
with ``--eval-holdout 0 --max-batches N``) and prints one JSON line:

    python -m containerpilot_tpu_torch.workload.evaluate \\
        --checkpoint-dir /ckpt --data-dir /data --eval-holdout 64 \\
        --d-model 1024 ...   (model flags must match the checkpoint)

``--eval-holdout`` is required and must equal the trainer's value. The
loss is ``modelcfg.average_eval_loss``, the trainer's in-loop eval, so
the numbers are comparable by construction. Only the params leave disk
(the checkpoint is memory-mapped). ``--moe-experts E`` scores a
switch-MoE checkpoint with drop-free routing, whatever capacity it was
trained with.
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
    parser.add_argument("--window", type=int, default=0,
                        help="sliding-window attention (must match the "
                        "checkpoint)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="switch-MoE experts (must match the "
                        "checkpoint)")
    parser.add_argument(
        "--eval-holdout", type=int, required=True,
        help="score the dataset's LAST N windows; MUST equal the trainer's "
        "--eval-holdout (0 = score the training stream from its head)",
    )
    parser.add_argument("--max-batches", type=int, default=0,
                        help="cap scored batches (0 = the whole split)")
    parser.add_argument("--use-ema", action="store_true",
                        help="score the checkpoint's EMA shadow weights")
    parser.add_argument("--lora-dir", default="",
                        help="merge the trained LoRA adapter of this "
                        "checkpoint dir into the params before scoring")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="rank of the adapter in --lora-dir")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..models.transformer import TransformerConfig
    from .data import TokenShardDataset
    from .modelcfg import average_eval_loss, derive_d_ff, restore_merged_params

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab_size=args.vocab,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=derive_d_ff(args.d_model),
        max_seq_len=args.seq_len,
        moe_experts=args.moe_experts,
        loss_chunk=args.loss_chunk,
        window=args.window,
    )
    restored = restore_merged_params(
        cfg, args.checkpoint_dir, use_ema=args.use_ema,
        lora_dir=args.lora_dir, lora_rank=args.lora_rank, device=device,
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
        "lora": bool(args.lora_dir),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
