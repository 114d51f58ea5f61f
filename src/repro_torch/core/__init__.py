"""Solver core of the port: SEM operators, geometry, CG and routing."""
