"""The card's mutant kernels still have their text to replace.

``test_torch_gpu.MUTANTS`` plants each fault by replacing one text of a CUDA
source in a copy of ``csrc/``; a text that no longer occurs once, after an
edit of the source, leaves the mutant unbuilt. This runs on the CPU, so an
edit that loses a mutant shows without a card.
"""

import os

import pytest

from artes_tpu_torch import _build
from artes_tpu_torch.cells import KERNEL_CELLS
from test_torch_gpu import MUTANTS
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("fault", sorted(MUTANTS))
def test_mutant_text_occurs_once(fault):
    """The text occurs exactly once in its source, the replacement differs
    from it, and every cell named to see the fault is a gate cell."""
    file, old, new, cell_names = MUTANTS[fault]
    with open(os.path.join(_build.CSRC_DIR, file)) as fh:
        text = fh.read()
    assert text.count(old) == 1, f"{fault}: the text occurs {text.count(old)} times in {file}"
    assert new != old
    assert cell_names and set(cell_names) <= set(KERNEL_CELLS)
