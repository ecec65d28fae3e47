"""Host-side data of the port: ``synthetic`` (seeded prompts for
serving traces)."""
