"""Core of the port: the CNN (``cnn``), device profiles (``allocate``)
and the deployment-plan artifact (``deploy``)."""
