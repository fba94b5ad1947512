"""The plain reference pipeline the benchmark compares the program with."""
