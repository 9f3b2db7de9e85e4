"""Store layer: directory, IO, checksums."""
