"""``p95_ms`` of the cells that send one frame at a time and wait for it:
split from ``p95_ms`` because the host sets their pace and their spread,
and with it their bound."""

from benchmarks.run import load

read = load("metrics", "p95_ms").read
