"""The port's host plan (its fuse.plan stage) a job of the window, ms."""

from portbench.telemetry import plan_ms as read  # noqa: F401
