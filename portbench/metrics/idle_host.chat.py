"""``idle_host.tput`` (one body), in the cells that report ``itl_p95_ms``."""

from portbench.harness.manifest import reader

read = reader("idle_host.tput")
