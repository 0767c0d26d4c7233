"""Share of the traced search window with no kernel on the card, %."""
from cmhbench.layer import idle_pct as read  # noqa: F401
