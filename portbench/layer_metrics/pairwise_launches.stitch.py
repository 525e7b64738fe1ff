"""pairwise_launches.stitch: device kernels (not copies or sets) that start
inside the traced stitch() jobs' register.pairwise_registrations spans, over
those jobs' crop-shape buckets (registration.last_telemetry["buckets"])."""

from portbench.spans import pairwise_launches as read  # noqa: F401
