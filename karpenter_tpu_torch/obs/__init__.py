"""Observability hooks of the port (the null trace the solver path takes)."""
