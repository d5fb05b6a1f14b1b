"""The benchmark's tests import ``portbench`` and ``artes_tpu_torch`` from the
checkout's root, wherever pytest is started."""

import pathlib
import sys

ROOT = str(pathlib.Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

# the tests run several to a machine: two threads each keep them from
# crowding each other out
torch.set_num_threads(2)
