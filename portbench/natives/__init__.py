"""Plain host code the benchmark makes its inputs and checks with: frozen copies, no program import."""
