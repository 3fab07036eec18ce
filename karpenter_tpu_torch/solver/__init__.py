"""Solvers of the port: the flat device solve, the hierarchical solve and
the scheduler that routes between them and the CPU oracle."""
