"""`python -m pbdagcon_tpu_torch`: the port's `dagcon` CLI."""

from pbdagcon_tpu_torch.cli import main

raise SystemExit(main())
