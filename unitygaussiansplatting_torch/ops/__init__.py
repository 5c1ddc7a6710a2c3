"""Per-splat math, binning and the kernels' wrappers with their plain versions."""
