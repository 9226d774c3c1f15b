"""The mix drivers, one module a ``driver`` name of ``traffic/*.json``:
``run(run) -> (readings, numbers, attempted, failed, memory_peak_bytes)``."""
