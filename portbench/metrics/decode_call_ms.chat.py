"""``decode_call_ms.tput`` (one body), in the cells that report ``itl_p95_ms``."""

from portbench.harness.manifest import reader

read = reader("decode_call_ms.tput")
