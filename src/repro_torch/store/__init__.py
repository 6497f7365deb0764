"""Storage substrate: block-granular tensor files, snapshots, progress
journal, integrity checks, I/O stats."""
