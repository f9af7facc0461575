"""Multi-device helpers of the port (counterpart of ``repro.parallel``):
the sharding rules and DTensor placements (``sharding``), the pipeline
schedule (``pipeline``) and the gradient codec the train step uses
(``compress``)."""
