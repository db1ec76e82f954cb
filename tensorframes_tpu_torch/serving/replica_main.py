"""Runnable entry for the demo fleet replica:

    python -m tensorframes_tpu_torch.serving.replica_main --demo [--device cpu]

A separate module (never imported by the serving package), so ``-m``
does not execute ``replica.py`` a second time, which the package imports
at init. All logic lives in :mod:`tensorframes_tpu_torch.serving.replica`.
"""

from tensorframes_tpu_torch.serving.replica import main

if __name__ == "__main__":
    raise SystemExit(main())
