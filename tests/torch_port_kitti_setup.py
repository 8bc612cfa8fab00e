"""Shared setup of the ``tests/test_torch_port_kitti*.py`` files (no tests
of its own): a small KITTI-format tree written from a seed by the port's
``com_tpu_torch.tools.kitti_tree`` (4 train and 2 val frames of 6,000
points, 10-15 labelled objects each, planes, a GT database), both
packages' configs pointed at it, and a bitwise comparison of items."""
from pathlib import Path

import numpy as np

from com_tpu.utils import config as jax_config
from com_tpu_torch.tools.kitti_tree import write_custom_tree, write_kitti_tree
from com_tpu_torch.utils import config as port_config

REPO = Path(__file__).resolve().parents[1]
POINTS = 6000
NUM_TRAIN, NUM_VAL = 4, 2


def small_tree(root, seed=0):
    return write_kitti_tree(root, seed=seed, num_train=NUM_TRAIN, num_val=NUM_VAL,
                            num_points=POINTS)


def small_custom_tree(root, seed=0):
    return write_custom_tree(root, seed=seed, num_train=2, num_val=2, num_points=POINTS)


def configs(path, root):
    """(com_tpu's cfg, the port's cfg) of the YAML at ``path``, DATA_PATH
    set to ``root``."""
    out = []
    for conf in (jax_config, port_config):
        cfg = conf.cfg_from_yaml_file(str(REPO / path), conf.CfgNode())
        cfg.DATA_CONFIG.DATA_PATH = str(root)
        out.append(cfg)
    return tuple(out)


def assert_same(a, b, where=""):
    """Bitwise equality of two nests of numpy arrays, lists, dicts and
    scalars; dtypes included."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (where, a.dtype, type(b))
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)
