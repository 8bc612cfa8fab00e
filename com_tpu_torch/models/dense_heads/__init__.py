from . import anchor_head, center_head, point_head  # noqa: F401  (registers heads)
