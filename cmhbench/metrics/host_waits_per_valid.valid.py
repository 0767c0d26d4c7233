"""The program's ``cmh.wait.*`` spans (host waits on the card) over the
traced ``valid``s."""
from cmhbench.program_spans import count, per


def read(outcome):
    return per(outcome, "valid", lambda t: count(t, "wait.*"))
