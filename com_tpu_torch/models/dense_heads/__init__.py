from . import center_head  # noqa: F401  (registers heads)
