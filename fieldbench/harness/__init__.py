"""The harness: finds a cell's configuration, traffic mix, limits and
per-layer readers by name, builds the system under test from them, runs
the measured window and judges what it produced against the reference."""
