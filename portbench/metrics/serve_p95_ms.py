"""serve_p95_ms: the 95th percentile of every request latency of the
window (host clock, from the start of ``prepare`` to the 3D poses on the
host), by linear interpolation between ranks; a failed request counts as
infinitely late."""

import math


def read(rec):
    xs = sorted(rec.latencies_s)
    if rec.kind != "serve" or not xs:
        return None
    pos = (len(xs) - 1) * 0.95
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return (xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)) * 1e3
