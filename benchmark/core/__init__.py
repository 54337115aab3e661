"""What every cell of the benchmark shares: seeds, clocks, the trace."""
