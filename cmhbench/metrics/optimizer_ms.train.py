"""Device milliseconds a step of the kernels launched inside BertAdam's
step (the traced window)."""


def read(outcome):
    t = outcome.trace
    if t is None or not t.span_count("optimizer"):
        return None
    return 1e3 * t.span_device_s("optimizer") / t.span_count("optimizer")
