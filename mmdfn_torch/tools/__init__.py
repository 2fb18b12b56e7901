"""Tools around the port: the reference-checkpoint importer, and a timer
of kernels B and D alone for comparing two trees on one card."""
