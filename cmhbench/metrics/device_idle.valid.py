"""Share of the traced valid window with no kernel on the card, %."""
from cmhbench.layer import idle_pct as read  # noqa: F401
