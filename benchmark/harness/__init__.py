"""The benchmark's general code: it finds a cell's files by name and
runs them.  Nothing here names a configuration, a mix or a metric."""
