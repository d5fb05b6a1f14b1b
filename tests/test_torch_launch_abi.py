"""The launch contract between ``transport/pool_cuda.py`` and the pool
kernels, read from the CUDA sources on the CPU (no card builds them here).

* ``struct PoolLaunch`` of ``csrc/pool_common.cuh`` and ``pool_cuda.PoolLaunch``
  have the same fields in the same order, each of the same width: a pointer,
  a 32-bit integer or a float. On a card ``pool_cuda._library`` holds the two
  sizes alike too, but a swap of two fields of one width only shows here.
* ``pool_cuda.OUT_I_SLOTS`` names as many out_i counters as each kernel adds
  (``N_OUT_IR``, ``N_OUT_I3``, ``N_OUT_IM`` and the radial flow
  instantiations' one more), and every counter a kernel names by a constant
  sits at that constant's slot.
"""

import os
import re

from artes_tpu_torch import _build
from artes_tpu_torch.transport import pool_cuda
from torch_threads import one_thread  # noqa: F401

FIELD = re.compile(r"^\s*(const\s+)?(?P<type>unsigned\s+long\s+long|unsigned\s+int|int|float"
                   r"|double)\s*(?P<ptr>\*?)\s*(?P<name>\w+);\s*(//.*)?$")
WIDTHS = {"int": "int32", "unsigned int": "int32", "float": "float"}
CTYPES = {"c_void_p": "pointer", "c_int": "int32", "c_uint": "int32", "c_float": "float"}

# the counters a kernel names by a constant (enum C_*), by their slot's name
NAMED_SLOTS = {
    "pool_radial": {"C_ANOM_R": "anomalies"},
    "pool_grid3d": {"C_ERR": "abandoned", "C_E031": "e031", "C_E032": "e032", "C_E034": "e034",
                    "C_ANOM": "anomalies"},
    "pool_march": {"C_ERR": "abandoned", "C_E031": "e031", "C_E032": "e032", "C_E034": "e034",
                   "C_ANOM": "anomalies", "C_EPEEL": "peel_walks_failed",
                   "C_PASSES": "cell_face", "C_BOOKED": "flow_booked"},
}


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as fh:
        return fh.read()


def _constants(text):
    """Every ``NAME = <int>`` of a source's enums and ``constexpr int``s."""
    return {k: int(v) for k, v in re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)\b", text)}


def test_pool_launch_is_the_kernels_struct():
    text = _source("pool_common.cuh")
    body = re.search(r"^struct PoolLaunch \{\n(.*?)^\};", text, re.M | re.S).group(1)
    fields = []
    for line in body.splitlines():
        m = FIELD.match(line)
        assert m, f"unparsed field of struct PoolLaunch: {line!r}"
        kind = "pointer" if m["ptr"] else WIDTHS[re.sub(r"\s+", " ", m["type"])]
        fields.append((m["name"], kind))
    assert fields == [(name, CTYPES[t.__name__]) for name, t in pool_cuda.PoolLaunch._fields_]
    assert fields[-1] == ("blocks", "int32")


def test_out_i_slots_are_the_kernels_counters():
    common = _constants(_source("pool_common.cuh"))
    geom3d = _source("pool_geom3d.cuh")
    radial, march = _source("pool_radial.cu"), _source("pool_march.cu")
    (n_radial,) = re.findall(r"constexpr int N_OUT_IR = N_OUT_I \+ (\d+);", radial)
    (flow_extra,) = re.findall(r"constexpr int NI = N_OUT_IR \+ \(FLOW \? (\d+) : 0\);", radial)
    counts = {"pool_radial": common["N_OUT_I"] + int(n_radial),
              "pool_radial_flow": common["N_OUT_I"] + int(n_radial) + int(flow_extra),
              "pool_grid3d": _constants(geom3d)["N_OUT_I3"],
              "pool_march": _constants(march)["N_OUT_IM"]}
    assert {k: len(v) for k, v in pool_cuda.OUT_I_SLOTS.items()} == counts
    named = {"pool_radial": _constants(radial), "pool_grid3d": _constants(geom3d),
             "pool_march": {**_constants(geom3d), **_constants(march)}}
    for kernel, slots in NAMED_SLOTS.items():
        for const, slot in slots.items():
            assert pool_cuda.OUT_I_SLOTS[kernel].index(slot) == named[kernel][const], \
                (kernel, const)
    assert pool_cuda.OUT_I_SLOTS["pool_radial_flow"][-1] == "flow_booked"
