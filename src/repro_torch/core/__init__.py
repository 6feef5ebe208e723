from .similarity import time_horizon  # noqa: F401
