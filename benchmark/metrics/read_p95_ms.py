"""read_p95_ms.objects: the 95th percentile (nearest rank) of the latency
of every read in a traced window, as object_read_p95_ms takes it from an
untraced one.  Per layer, because the read latency of one 20-s window
follows the host's speed by more than an end-to-end bound of 25% holds."""

from .object_read_p95_ms import read  # noqa: F401
