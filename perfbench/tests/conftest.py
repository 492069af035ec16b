"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that run on the card only (they skip elsewhere).

    python -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
