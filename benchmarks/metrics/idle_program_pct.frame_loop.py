"""``idle_program_pct`` of the frame-loop cells, which moves their
``p95_ms.frame_loop``."""

from benchmarks.run import load

read = load("metrics", "idle_program_pct").read
