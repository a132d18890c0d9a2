"""Fleet-wide KV reuse (counterpart of ``containerpilot_tpu/kvtier/``):
the prefix digest the fleet routes on (``digest.py``), the host-RAM spill
tier under the prefix cache's LRU (``spill.py``) and the handoff wire
that moves one cached entry between replicas (``handoff.py``)."""
from .digest import (
    DIGEST_MAX_BYTES,
    FP_TOKENS,
    encode_fingerprints,
    encode_migration_note,
    parse_digest,
    parse_kv_counters,
    parse_kv_note,
    parse_migration_note,
    prefix_fingerprint,
)
from .handoff import (
    KV_PATH,
    KV_PULL_PATH,
    KVTransferError,
    MIGRATE_PATH,
    fetch_kv,
    kv_transfer_plan,
    plan_migration,
    push_kv,
    rebuild_kv,
)
from .spill import HostSpillTier

__all__ = [
    "DIGEST_MAX_BYTES",
    "FP_TOKENS",
    "HostSpillTier",
    "KVTransferError",
    "KV_PATH",
    "KV_PULL_PATH",
    "MIGRATE_PATH",
    "encode_fingerprints",
    "encode_migration_note",
    "fetch_kv",
    "kv_transfer_plan",
    "parse_digest",
    "parse_kv_counters",
    "parse_kv_note",
    "parse_migration_note",
    "plan_migration",
    "prefix_fingerprint",
    "push_kv",
    "rebuild_kv",
]
