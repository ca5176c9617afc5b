"""The harness: the one traffic generator, the entry points, the window,
the trace readers and the comparison that decides correct."""
