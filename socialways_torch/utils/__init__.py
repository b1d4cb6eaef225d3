"""Host-side helpers: profiling, geometry, lr schedules."""
