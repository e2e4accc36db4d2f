"""API servers: REST with the reference's read/write port split."""
