"""Multi-device helpers of the port (counterpart of ``repro.parallel``):
so far the gradient codec the train step uses."""
