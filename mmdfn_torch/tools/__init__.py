"""Tools around the port: the reference-checkpoint importer."""
