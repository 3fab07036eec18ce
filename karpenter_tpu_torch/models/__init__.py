"""Host models of the port: copies of the reference package's models."""
