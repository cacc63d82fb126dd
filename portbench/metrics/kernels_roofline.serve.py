"""kernels_roofline.serve: the serving path's hand kernels (``tail2_kernel``
as deconv0 and as deconv1, deconv2 + head; ``quantize_kernel`` and
``aggregation_kernel``, the fusion) against their roofline: the sum of
their least times at the chip's peaks (portbench/counts.py, from the
configuration's shapes) over the sum of their device times, in the traced
sub-window. Nothing is read unless each ran as often as a request needs."""

from portbench import counts
from portbench.trace import HAND

# kernel name -> launches a request
EXPECTED = {"tail2_kernel": 3, "quantize_kernel": 1, "aggregation_kernel": 1}


def read(rec):
    tr = rec.trace
    if rec.kind != "serve" or tr is None or not tr.iterations:
        return None
    n = {k: 0 for k in EXPECTED}
    us = 0.0
    for name, a, b in tr.ops:
        if HAND not in name:
            continue
        short = name.split(HAND, 1)[1].split("<")[0].split("(")[0]
        if short in n:
            n[short] += 1
            us += b - a
    if any(n[k] != v * tr.iterations for k, v in EXPECTED.items()) or us <= 0:
        return None
    bound_ms = sum(counts.serve_hand_kernel_bounds(rec.cfg, rec.cell["groups"],
                                                   rec.cell["views"]).values())
    return 100.0 * bound_ms * tr.iterations / (us / 1e3)
