"""The share of the traced jobs' idle time on the card inside no program
span (a utils.profiling stage) on the jobs' thread, %."""

from portbench.spans import idle_unspanned_pct as read  # noqa: F401
