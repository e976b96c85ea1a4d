"""Cost model, profiler, solver, partition execution, engine and sync."""
