"""Training of the port (counterpart of ``repro.train``): the step
builders, the checkpointer and the fault-tolerant loop."""
