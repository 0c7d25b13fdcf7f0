"""The benchmark's yardstick: cell lookup, traffic, weights, drivers, trace
reading and the comparison that decides `correct`. Nothing here imports the
program except `entries/` (the drivers) and `harness/program.py`."""
