"""The benchmark's own CPU tests: ``python -m pytest perfbench/tests``
from the root of the repository.  They import the benchmark as the
package ``perfbench`` and the program as ``dcfp_tpu_torch``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
