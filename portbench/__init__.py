"""The port's benchmark: one run of one cell a process (``run.py``).

See README.md."""
