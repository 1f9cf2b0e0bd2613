#!/usr/bin/env python
"""Thin wrapper over ``python -m repro_torch.analysis`` for people (and CI) who
prefer a script path. Forwards every argument (the counterpart of
``scripts/lint_repro.py``); like the module it runs on the card unless
given ``--device cpu``."""

import os
import sys

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
