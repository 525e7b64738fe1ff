"""The share of the traced jobs' own time with no kernel, copy or set on the card, %."""

from portbench.telemetry import idle_pct as read  # noqa: F401
