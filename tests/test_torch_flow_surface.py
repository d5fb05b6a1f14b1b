"""Flow diagnostics over a Lambert surface in the plain PyTorch version
against the JAX package: the surface cases of ``test_torch_flow.py``
(``check_plain_flow``: counts bit-equal, moments at rtol 1e-10, the flow
arrays at rtol 1e-9 at float64 on the CPU), in a file of their own so that
the two files share the time between test workers.
"""

import pytest

from test_torch_flow import SURFACE_CASES, check_plain_flow
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("case", SURFACE_CASES)
def test_plain_flow_matches_jax_f64(case):
    check_plain_flow(case)
