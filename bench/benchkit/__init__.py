"""The benchmark's harness: cell lookup, traffic, weights, the closed loop
and its window, the device trace, and the check against the reference.

Everything a cell, a traffic mix or a metric owns lives in a file of its
own under ``bench/`` (``configs/``, ``traffic/``, ``metrics/``,
``limits/``), found by the name ``BENCHMARK.json`` gives it."""
