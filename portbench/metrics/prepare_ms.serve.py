"""prepare_ms.serve: mean milliseconds of the benchmark's host span around
``ServingPipeline.prepare`` (upload and packing), ending in a synchronize,
over the traced sub-window's requests."""


def read(rec):
    xs = rec.spans_ms.get("prepare")
    if rec.kind != "serve" or not xs:
        return None
    return sum(xs) / len(xs)
