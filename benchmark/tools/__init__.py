"""Tools that set and check the benchmark's correctness limits."""
