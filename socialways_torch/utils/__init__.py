"""Host-side helpers: profiling."""
