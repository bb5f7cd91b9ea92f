"""Device ops of the port: one-hop sampling and the dedup reindex."""
