"""Configuration."""

from orb_slam3_noted_tpu_torch.io.config import SlamConfig  # noqa: F401
