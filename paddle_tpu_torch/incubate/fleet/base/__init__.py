from paddle_tpu_torch.incubate.fleet.base import role_maker  # noqa: F401
