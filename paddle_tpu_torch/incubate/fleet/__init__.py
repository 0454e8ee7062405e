"""The reference's fleet import paths (python/paddle/fluid/incubate/fleet/):
shims over the one implementation in ``paddle_tpu_torch/parallel/fleet.py``,
so reference user code imports unchanged."""
