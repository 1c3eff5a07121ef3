"""``python3 -m adacom_tpu_torch`` is the SQL shell (shell.py)."""

from adacom_tpu_torch.shell import main

raise SystemExit(main())
