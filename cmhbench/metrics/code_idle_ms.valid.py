"""Milliseconds a traced ``valid`` with nothing on the card inside the
program's ``cmh.get_code`` spans (code generation of both sets)."""
from cmhbench.program_spans import idle_s, per


def read(outcome):
    return per(outcome, "valid", lambda t: 1e3 * idle_s(t, "get_code"))
