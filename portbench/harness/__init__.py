"""The benchmark's harness: manifest, traffic, the program's build from
seeded slices, the measured window, the profiler's reading, the cost
functions and the correctness check."""
