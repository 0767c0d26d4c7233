"""Device milliseconds a traced ``valid`` of the kernels launched inside the
program's ``cmh.encode_image`` spans (image tower and hash head)."""
from cmhbench.program_spans import device_s, per


def read(outcome):
    return per(outcome, "valid", lambda t: 1e3 * device_s(t, "encode_image"))
