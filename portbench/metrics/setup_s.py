"""setup_s: seconds from the process's start to the first timed request or
step (imports, the kernels' libraries, weights, calibration and
quantisation, warm-up), host clock."""


def read(rec):
    return rec.setup_s
