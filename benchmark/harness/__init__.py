"""The general harness: cells, inputs, entries, windows, traces and the check."""
