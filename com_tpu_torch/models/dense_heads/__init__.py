from . import anchor_head, center_head  # noqa: F401  (registers heads)
