"""``python -m containerpilot_tpu_torch.fleet`` runs the gateway CLI."""
from .gateway import main

if __name__ == "__main__":
    raise SystemExit(main())
