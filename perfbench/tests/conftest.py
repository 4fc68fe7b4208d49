"""The benchmark's tests import ``perfbench`` and the port from the root of
the checkout."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Several test workers share the host: two threads each.
import torch  # noqa: E402

torch.set_num_threads(2)
