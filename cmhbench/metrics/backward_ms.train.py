"""Device milliseconds a traced train step of the kernels launched, on any
thread (the autograd engine's), while the program's ``cmh.backward`` span
is open."""
from cmhbench.program_spans import device_s, per


def read(outcome):
    return per(outcome, "train_step", lambda t: 1e3 * device_s(t, "backward"))
