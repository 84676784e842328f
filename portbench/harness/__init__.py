"""The benchmark harness: program set-up, traffic, the window, the trace."""
