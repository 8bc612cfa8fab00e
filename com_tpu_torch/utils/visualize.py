"""BEV scene rendering with matplotlib (the port's copy of
``com_tpu/utils/visualize.py``; reference tools/visual_utils).

The reference draws interactive 3D scenes with open3d/mayavi; the demo
renders a bird's-eye-view PNG instead: the point cloud coloured by height,
GT boxes in green, predictions in red with score labels.  matplotlib is
imported only inside ``draw_scene_bev``; without it the call raises.
"""
from __future__ import annotations

import numpy as np


def _box_corners_bev(boxes):
    """(N, 7) -> (N, 4, 2) BEV corner loops."""
    if len(boxes) == 0:
        return np.zeros((0, 4, 2))
    signs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    local = signs[None] * boxes[:, None, 3:5] / 2
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x, y], -1) + boxes[:, None, :2]


def draw_scene_bev(points, gt_boxes=None, pred_boxes=None, pred_scores=None,
                   pred_labels=None, class_names=None, save_path=None,
                   point_range=None, title=None):
    """Render one scene to a PNG (draw_scenes role).  Returns the figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("draw_scene_bev needs matplotlib, which is not installed; "
                          "run the demo without --save_viz") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 12))
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=0.2, c=pts[:, 2], cmap="viridis",
               alpha=0.6, linewidths=0)

    def draw_boxes(boxes, color, labels=None, scores=None):
        corners = _box_corners_bev(np.asarray(boxes))
        for i, quad in enumerate(corners):
            loop = np.concatenate([quad, quad[:1]], axis=0)
            ax.plot(loop[:, 0], loop[:, 1], color=color, linewidth=1.2)
            # heading tick from center to front-face midpoint
            front = (quad[1] + quad[2]) / 2
            center = quad.mean(axis=0)
            ax.plot([center[0], front[0]], [center[1], front[1]],
                    color=color, linewidth=0.8)
            if scores is not None:
                name = ""
                if labels is not None and class_names is not None:
                    li = int(labels[i]) - 1
                    if 0 <= li < len(class_names):
                        name = f"{class_names[li]} "
                ax.text(quad[0, 0], quad[0, 1], f"{name}{float(scores[i]):.2f}",
                        color=color, fontsize=6)

    if gt_boxes is not None and len(gt_boxes):
        draw_boxes(gt_boxes, "limegreen")
    if pred_boxes is not None and len(pred_boxes):
        draw_boxes(pred_boxes, "red", pred_labels, pred_scores)

    if point_range is not None:
        ax.set_xlim(point_range[0], point_range[3])
        ax.set_ylim(point_range[1], point_range[4])
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
    return fig
