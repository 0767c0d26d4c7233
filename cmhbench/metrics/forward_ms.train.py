"""Device milliseconds a traced train step of the kernels launched inside
the program's ``cmh.forward`` span (towers and heads)."""
from cmhbench.program_spans import device_s, per


def read(outcome):
    return per(outcome, "train_step", lambda t: 1e3 * device_s(t, "forward"))
