"""The benchmark's yardstick: cell lookup, traffic, weights, drivers, trace
reading and the comparison that decides `correct`. Nothing of the benchmark
imports the program except `entries/` (the drivers), `adapters/` (each
model family's configuration and weights as the program takes them) and
`harness/program.py`; `layouts/`, `reference/` and `counts/` import
nothing of it."""
