"""Plain references of published models: straightforward float32 torch,
independent of the port's modules and kernels, that the port's fast
paths are held to."""
