"""State, ring access, protocol steps and their kernels."""
