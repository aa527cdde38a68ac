"""``python -m unmicst_tpu_torch IMAGE ...`` — the CLI (on the GPU)."""

from unmicst_tpu_torch.cli import main

raise SystemExit(main())
