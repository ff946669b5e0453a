"""The paper's contribution (the port of ``repro.core``): labels, metrics
and threshold calibration, router training, the routing policies and
cost accounting, and the end-to-end experiment pipeline."""
