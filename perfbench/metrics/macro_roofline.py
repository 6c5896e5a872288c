"""``macro_roofline.*`` (%): the macro kernel's share of its roofline.

The least time the profiled window's macro matmuls could take
(``peaks.macro_bound_s`` summed over every product of every call), over
the device time of the kernels that ran them. The macro's kernel is B1,
``plane_mma_kernel`` instantiated for bit planes and a flash ADC (B2 and
B3 share the template under other policies).
"""

import re

from perfbench import peaks

B1_KERNEL = re.compile(r"plane_mma_kernel.*BitPlanes.*Flash")


def read(rec):
    if rec.trace is None:
        return None
    b1_s = sum(e - s for s, e, name in rec.trace.kernels()
               if B1_KERNEL.search(name)) * 1e-9
    if b1_s <= 0:
        return None
    op = rec.cell.cfg["cim"]
    bound = sum(peaks.macro_bound_s(p, op["act_bits"], op["weight_bits"])
                for p in rec.cell.macro_products()) * rec.trace.calls
    return 100.0 * bound / b1_s
