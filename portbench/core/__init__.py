"""The general parts of the benchmark: finding a cell's files by name,
the measured window, the trace, the correctness verdict and the result
line.  Nothing here names a configuration, a traffic mix or a metric."""
