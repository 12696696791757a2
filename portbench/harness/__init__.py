"""The benchmark's machinery: cells, set-up, windows, traces, comparisons."""
