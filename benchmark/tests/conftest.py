"""The harness's tests run from the repository root:
python -m pytest benchmark/tests (CPU; nothing here needs a card)."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
