"""mfu.serve: the model's int8 operations a request (every convolution,
deconvolution and the fusion's products, two a multiply-accumulate, from
the configuration's shapes) times the window's requests, over the window's
seconds and the chip's 1,979 TOP/s int8 peak."""

from portbench import counts


def read(rec):
    if rec.kind != "serve" or not rec.window_s > 0 or not rec.groups:
        return None
    ops = counts.request_ops(rec.cfg, rec.cell["groups"], rec.cell["views"])
    requests = rec.groups / rec.cell["groups"]
    return 100.0 * ops * requests / rec.window_s / counts.PEAK_INT8_OPS
