"""The KITTI image side of the port against ``com_tpu`` on the CPU: the PNG
reader against PIL (which ``com_tpu`` reads with; the port does not), the
image items of ``KittiDataset``, the image collate, and the KITTI image
copy-paste of the GT sampler (``IMG_AUG_TYPE: kitti``), bitwise, on hand-
built scenes and through ``voxel_rcnn_car_focal_multimodal.yaml``'s own
DATA_CONFIG over a seeded tree with images (``kitti_tree --images``).
"""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from com_tpu.data import build_dataloader as jax_build_dataloader
from com_tpu.data.augmentor.database_sampler import DataBaseSampler as JaxSampler
from com_tpu.data.kitti import calibration as jcal
from com_tpu.data.kitti.kitti_dataset import KittiDataset as JaxKitti
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.data.augmentor.database_sampler import DataBaseSampler
from com_tpu_torch.data.kitti import calibration as pcal
from com_tpu_torch.data.kitti.kitti_dataset import KittiDataset
from com_tpu_torch.data.kitti.png import read_png, write_png
from com_tpu_torch.tools.kitti_tree import write_kitti_tree
from torch_port_kitti_setup import NUM_TRAIN, NUM_VAL, POINTS, assert_same, configs

FOCAL = "configs/kitti_models/voxel_rcnn_car_focal_multimodal.yaml"


def _encode(img, filters):
    """A PNG of uint8 ``img`` with row y filtered by ``filters[y]`` (0-4),
    each filter as the PNG specification defines it."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = filters[y]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_pil(tmp_path, filt, channels):
    rng = np.random.RandomState(channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    img[5:12] = img[5:6]  # flat rows, a flat band: the predictors differ there
    filters = (rng.randint(0, 5, 23) if filt == "mixed" else [filt] * 23)
    path = tmp_path / "a.png"
    path.write_bytes(_encode(img, filters))
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil, img)
    np.testing.assert_array_equal(read_png(path), pil)


def test_png_writer_and_refusals(tmp_path):
    """``write_png`` reads back in PIL (RGB, grey); 16-bit, palette and
    interlaced files raise by name."""
    img = (np.random.RandomState(0).rand(20, 30, 3) * 255).astype(np.uint8)
    for name, a in (("w0", img), ("grey", img[..., 0])):
        write_png(tmp_path / f"{name}.png", a)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"{name}.png")), a)
    Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(tmp_path / "d16.png")
    Image.fromarray(img).convert("P").save(tmp_path / "pal.png")
    raw = bytearray((tmp_path / "w0.png").read_bytes())
    raw[28] = 1  # IHDR's interlace byte (the CRC is not checked)
    (tmp_path / "inter.png").write_bytes(bytes(raw))
    for name, what in (("d16", "16-bit"), ("pal", "colour type 3"), ("inter", "interlaced")):
        with pytest.raises(NotImplementedError, match=what):
            read_png(tmp_path / f"{name}.png")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_images")
    info = write_kitti_tree(root, seed=4, num_train=NUM_TRAIN, num_val=NUM_VAL,
                            num_points=POINTS, images=True)
    return root, info


def test_tree_images_show_the_objects(tree):
    root, info = tree
    img = read_png(root / "training" / "image_2" / f"{info['train'][0]}.png")
    assert img.shape == (375, 1242, 3) and img.dtype == np.uint8
    label = (root / "training" / "label_2" / f"{info['train'][0]}.txt").read_text().split("\n")[0]
    x1, y1, x2, y2 = (int(float(v)) for v in label.split()[4:8])  # the first label's image box
    assert x2 > x1 and y2 > y1
    inside = img[y1 + 1:y2 - 1, x1 + 1:x2 - 1].astype(np.float32).mean((0, 1))
    assert np.abs(inside - img[:40].astype(np.float32).mean((0, 1))).max() > 20


@pytest.mark.parametrize("training", [False, True])
def test_image_items_and_collate_match_jax(tree, training):
    """The focal YAML's items (images in [0, 1], the two calibration
    matrices, gt_boxes2d, with its GT sampling in training) and their
    collate, bitwise; the collate pads to IMAGE_PAD_SHAPE (384, 1280)."""
    root, _ = tree
    jcfg, pcfg = configs(FOCAL, root)
    jds = JaxKitti(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=training, seed=3)
    pds = KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=training, seed=3)
    items = []
    for ds in (jds, pds):
        got = [ds[i] for i in range(2)]
        items.append(([{k: v for k, v in it.items() if k != "calib"} for it in got],
                      ds.collate_batch(got)))
    assert_same(items[0], items[1])
    batch = items[1][1]
    assert batch["images"].shape == (2, 384, 1280, 3)
    np.testing.assert_array_equal(batch["image_shape"], [[375, 1242]] * 2)
    assert batch["trans_lidar_to_cam"].shape == (2, 4, 4)
    assert batch["trans_cam_to_img"].shape == (2, 3, 4)
    assert batch["gt_boxes2d"].shape[-1] == 4 and (batch["gt_boxes2d"][..., 2] > 0).any()
    assert 0.0 <= batch["images"].min() and batch["images"].max() <= 1.0


def test_dataloader_with_image_paste_matches_jax_bitwise(tree):
    """Two epochs of batch 2 through each package's ``build_dataloader`` with
    the focal YAML's own augmentation (the image copy-paste from the tree's
    database, the road plane with calib, the world augmentations), seed 3:
    bitwise, and pastes survive the 2D prefilter."""
    root, _ = tree
    jcfg, pcfg = configs(FOCAL, root)
    runs = []
    for build, cfg in ((jax_build_dataloader, jcfg), (build_dataloader, pcfg)):
        _, loader = build(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 2, training=True, seed=3,
                          workers=1)
        batches = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            batches += list(loader)
        runs.append(batches)
    assert_same(runs[0], runs[1])
    assert sum(int((b["true_object"] == 2).sum()) for b in runs[1]) > 0


def _scene(cal, rng):
    """A scene with one GT Car and a donor Car (its own calib and image) in
    ``cal``'s module (either package's calibration)."""
    v2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], np.float64)
    calib = cal.Calibration({"P2": np.array([100.0, 0, 200, 0, 0, 100, 150, 0, 0, 0, 1, 0]),
                             "R0_rect": np.eye(3).ravel(), "Tr_velo_to_cam": v2c.ravel()})
    h, w = 300, 400
    image = rng.rand(h, w, 3).astype(np.float32)
    gt_box = np.array([[10.0, 0.0, 0.0, 4.0, 2.0, 1.6, 0.0]], np.float32)
    gt2d = cal.boxes3d_kitti_camera_to_imageboxes(cal.boxes3d_lidar_to_kitti_camera(gt_box, calib),
                                                  calib, (h, w))
    pts = np.concatenate([rng.uniform(5, 40, (500, 1)), rng.uniform(-10, 10, (500, 1)),
                          rng.uniform(-1.5, 1.5, (500, 1)), rng.rand(500, 1)], 1).astype(np.float32)
    pts = np.concatenate([pts, [[30.0, 10.0, 0.0, 0.5]]]).astype(np.float32)  # behind the donor
    infos = []
    for k, (x, y) in enumerate(((15.0, 5.0), (20.0, 0.1), (12.0, -6.0))):
        obox = np.array([x, y, 0.0, 4.0, 2.0, 1.6, 0.3 * k], np.float32)
        opts = rng.rand(40, 4).astype(np.float32) - 0.5
        opts[:, :3] = opts[:, :3] * [3.5, 1.8, 1.4] + obox[:3]
        obb = cal.boxes3d_kitti_camera_to_imageboxes(
            cal.boxes3d_lidar_to_kitti_camera(obox[None], calib), calib, (h, w))[0]
        infos.append({"name": "Car", "box3d_lidar": obox, "num_points_in_gt": 40,
                      "points": opts, "calib": calib,
                      "image": (rng.rand(h, w, 3) * 255).astype(np.float32), "bbox": obb,
                      "difficulty": 0})
    dd = {"gt_boxes": gt_box, "gt_names": np.array(["Car"]), "gt_boxes_mask": np.ones(1, bool),
          "points": pts, "images": image, "calib": calib, "gt_boxes2d": gt2d,
          "road_plane": np.array([0.0, -1.0, 0.0, 1.6])}
    return infos, dd


@pytest.mark.parametrize("thresh", [0.5, 0.15])
@pytest.mark.parametrize("road", [False, True])
def test_image_paste_matches_jax_on_a_scene(thresh, road):
    """Three donors, one behind the GT (2D IoU ~0.2 with it): the prefilter,
    the road lift, the recalibrated points and boxes, the pasted image, the
    occluded points removed, bitwise."""
    outs = []
    for cal, cls in ((jcal, JaxSampler), (pcal, DataBaseSampler)):
        infos, dd = _scene(cal, np.random.RandomState(9))
        cfg = {"SAMPLE_GROUPS": ["Car:3"], "IMG_AUG_TYPE": "kitti", "NUM_POINT_FEATURES": 4,
               "LIMIT_WHOLE_SCENE": False, "IMG_AUG_IOU_THRESH": thresh, "USE_ROAD_PLANE": road}
        sampler = cls(None, cfg, ["Car"], db_infos={"Car": infos},
                      rng=np.random.RandomState(1))
        out = sampler(dict(dd))
        outs.append({k: v for k, v in out.items() if k != "calib"})
    assert_same(outs[0], outs[1])
    n = len(outs[1]["gt_boxes"])
    assert (n == 4) if thresh == 0.5 else (2 <= n < 4)
    assert outs[1]["gt_boxes2d"].shape == (n, 4) and len(outs[1]["points"]) < 501 + 120


def test_focal_multimodal_through_train_and_test_clis(tree, tmp_path):
    """``voxel_rcnn_car_focal_multimodal.yaml`` from its own DATA_CONFIG (the
    images read without PIL, the image copy-paste) through the port's train
    CLI (1 epoch of 2 steps) and test CLI (the KITTI AP table), the grid cut
    to 0.32 x 0.32 x 0.1 m voxels over 40.96 m so that a CPU step stays
    short."""
    import torch

    from com_tpu_torch.tools import test, train

    root, info = tree
    sets = ["--set", "DATA_CONFIG.DATA_PATH", str(root),
            "DATA_CONFIG.POINT_CLOUD_RANGE", "[0, -20.48, -3, 40.96, 20.48, 1]",
            "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[0.32, 0.32, 0.1]",
            "DATA_CONFIG.DATA_PROCESSOR.2.MAX_NUMBER_OF_VOXELS.train", "4096",
            "DATA_CONFIG.DATA_PROCESSOR.2.MAX_NUMBER_OF_VOXELS.test", "4096",
            "MODEL.BACKBONE_3D.VOXEL_CAPS", "[4096, 4096, 2048, 1024]",
            "MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_PRE_MAXSIZE", "256",
            "MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE", "256",
            "MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE", "256"]
    base = ["--cfg_file", FOCAL, "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "out"), "--batch_size", "2"]
    first = train.main(base + ["--epochs", "1", "--seed", "3"] + sets)
    assert first["iterations"] == len(info["train"]) // 2 == 2
    net = first["state"].net
    assert type(net.backbone_3d).__name__ == "VoxelBackBone8xFocal"
    assert all(torch.isfinite(p).all() for p in net.parameters())
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    (res,) = test.main(base + ["--ckpt", str(ckpt)] + sets)
    assert [a["frame_id"] for a in res["det_annos"]] == info["val"]
    assert res["result_str"].splitlines()[0].startswith("Car AP_bev R40 easy/mod/hard")


def test_caddn_clis_fail_alike(tmp_path, monkeypatch):
    """Kept from com_tpu: ``CaDDN.yaml``'s DATA_CONFIG has no GET_ITEM_LIST
    (points only) and no dataset of either package writes ``depth_maps``,
    so neither package's train CLI can run it: both stop at the missing
    "images" (the JAX CLI when it initialises the model from
    ``device_batch_keys``, the port's at the first forward).  CaDDN trains
    at the model and step level (``test_torch_port_image_models.py``)."""
    import runpy
    import sys

    from com_tpu_torch.tools import train
    from torch_port_kitti_setup import REPO

    # the JAX CLI's global batch is the batch x the devices (8 in these tests)
    write_kitti_tree(tmp_path / "kitti", seed=0, num_train=8, num_val=1, num_points=2000)
    yaml = str(REPO / "configs/kitti_models/CaDDN.yaml")
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tmp_path / "kitti")]
    monkeypatch.setattr(sys, "argv", ["train.py", "--cfg_file", yaml, "--workers", "1",
                                      "--epochs", "1", "--batch_size", "1", "--output_dir",
                                      str(tmp_path / "jax")] + data)
    with pytest.raises(KeyError, match="images"):
        runpy.run_path(str(REPO / "tools/train.py"), run_name="__main__")
    with pytest.raises(KeyError, match="images"):
        train.main(["--cfg_file", yaml, "--device", "cpu", "--workers", "1", "--epochs", "1",
                    "--batch_size", "2", "--output_dir", str(tmp_path / "port")] + data)
