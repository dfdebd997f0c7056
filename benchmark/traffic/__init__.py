"""The benchmark's traffic kinds, one module each, found by name."""
