"""The harness: set-up, the timed window, the trace and the result line."""
