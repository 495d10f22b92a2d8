"""small shared utilities: checkpoint and resume, profiling, and the SciPy
ODE condensation solver that cross-checks the implicit one"""
