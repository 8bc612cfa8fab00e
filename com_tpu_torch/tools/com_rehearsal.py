"""Multi-epoch COM feedback rehearsal of the port (counterpart of
``tools/com_rehearsal.py``; the reference's contract, train_utils.py:321-328:
the epoch-end confidences flow back into the GT-Aug curriculum sampler and
shift its group distribution).

Drives the port's train CLI (``python -m com_tpu_torch.tools.train``) on a
3-class COM config (a confidence tensor of ``conf_shape_for`` the config,
(3, 96)) for N epochs, then:
  1. reads the loss curve from ``metrics.jsonl``,
  2. rebuilds each epoch's per-class sampling distribution from the
     confidences in ``checkpoint_epoch_N.pth`` (``group_probability`` is a
     function of the confidences, the epoch and the database's group sizes,
     and the sampler is rebuilt as training built it: seed 666),
  3. asserts that the distribution moves off the size prior once
     confidences feed back (L1 > 0.05 at the last fed epoch, non-zero at
     epoch 1) and keeps moving between epochs (> 0.01),
  4. runs the CLI for one epoch more and asserts that the resume kept the
     epoch checkpoint's confidences bitwise and trained on to finite ones,
  5. writes ``com_rehearsal.md`` and ``com_rehearsal.jsonl`` under
     ``--output_dir``.

    python -m com_tpu_torch.tools.com_rehearsal [--epochs 3] [--device cuda|cpu]
        [--cfg configs/synthetic_models/centerpoint_synth_com.yaml]
        [--output_dir output/com_rehearsal]

``--device`` defaults to ``cuda`` and the CLI raises without a card.
``main(argv, train=...)`` runs in-process; ``train(argv)`` runs the train
CLI on its arguments (default: ``run_train``, a child process).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def train_argv(cfg_file, epochs, out_dir, device, seed=666):
    """The train CLI's arguments for the rehearsal's runs."""
    return ["--cfg_file", str(cfg_file), "--epochs", str(epochs), "--batch_size", "2",
            "--workers", "2", "--fix_random_seed", "--seed", str(seed),
            "--output_dir", str(out_dir), "--ckpt_save_time_interval", "0",
            "--device", str(device)]


def run_train(argv, timeout=7200):
    """``python -m com_tpu_torch.tools.train`` on ``argv`` from the repo's
    root; raises with the end of its output when it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "com_tpu_torch.tools.train", *argv], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-4000:])
        raise RuntimeError(f"com_tpu_torch.tools.train rc={proc.returncode}")
    return proc


def find_one(root, pattern):
    hits = list(Path(root).rglob(pattern))
    assert hits, f"no {pattern} under {root}"
    return hits[0]


def epoch_checkpoints(out_dir):
    """{epoch: checkpoint_epoch_N.pth} under ``out_dir``, oldest first."""
    out = {}
    for p in Path(out_dir).rglob("checkpoint_epoch_*.pth"):
        m = re.fullmatch(r"checkpoint_epoch_(\d+)\.pth", p.name)
        if m and p.is_file():
            out[int(m.group(1))] = p
    return dict(sorted(out.items()))


def checkpoint_confidences(path):
    """The sampler's (C, G) confidences saved in a checkpoint, as numpy."""
    from ..utils.checkpoint import load_checkpoint, sampler_confidences

    return sampler_confidences(load_checkpoint(path, map_location="cpu"))


def sampler_for(cfg):
    """The training sampler rebuilt as training built it (the same seed,
    hence the same database groups)."""
    from ..data import build_dataloader

    ds, _ = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), batch_size=2,
                             training=True, seed=666, workers=1)
    return ds.data_augmentor.gt_sampler


def distribution_report(sampler, class_names):
    """Per-class group-sampling distribution at the sampler's current epoch
    and confidences, beside the confidence-free size prior."""
    out = {}
    for cname in class_names:
        sg = sampler.sample_groups[cname]
        prob = sampler.group_probability(cname, sg)
        if prob is None:
            continue
        sizes = np.array([len(g) for g in sg["indices"]], np.float64)
        prior = sizes / sizes.sum()
        out[cname] = {
            "num_groups": int(len(prob)),
            "entropy": float(-(prob * np.log(np.maximum(prob, 1e-12))).sum()),
            "top_group": int(np.argmax(prob)),
            "l1_from_size_prior": float(np.abs(prob - prior).sum()),
            "prob": prob.tolist(),
        }
    return out


def rehearse(cfg_file, epochs, out_dir, device="cuda", train=run_train):
    """Steps 0-4 of the module's docstring; returns {"rows", "losses",
    "last_epoch", "conf_shape", "resumed_epoch"}.  Raises AssertionError at
    the first bar not met."""
    from ..train.step import conf_shape_for
    from ..utils.config import CfgNode, cfg_from_yaml_file

    out_dir = Path(out_dir)
    if out_dir.exists():
        # a stale run would make the resume skip every epoch and the
        # rehearsal pass on old files without training at all
        print(f"[0/5] clearing previous rehearsal output at {out_dir}")
        shutil.rmtree(out_dir)
    print(f"[1/5] training {epochs} epochs via com_tpu_torch.tools.train ({device}) ...")
    train(train_argv(cfg_file, epochs, out_dir, device))

    cfg = cfg_from_yaml_file(str(cfg_file), CfgNode())
    records = [json.loads(line)
               for line in find_one(out_dir, "metrics.jsonl").read_text().splitlines()]
    losses = [(r["step"], r["loss"]) for r in records if "loss" in r]

    print("[2/5] reconstructing per-epoch sampling distributions ...")
    ckpts = epoch_checkpoints(out_dir)
    assert len(ckpts) >= epochs, f"missing epoch checkpoints: {list(ckpts)}"
    sampler = sampler_for(cfg)
    class_names = list(cfg.CLASS_NAMES)
    conf_shape = tuple(conf_shape_for(cfg.MODEL, class_names))

    rows = []
    # epoch 0 trains with no feedback yet (the size prior)
    sampler.epoch = 0
    sampler.confidence_groups = None
    rows.append({"epoch": 0, "conf": None, "dist": distribution_report(sampler, class_names)})
    for ep, path in ckpts.items():
        conf = checkpoint_confidences(path)
        assert conf is not None and conf.shape == conf_shape, (None if conf is None
                                                               else conf.shape)
        sampler.epoch = ep  # the epoch that trains with this feedback
        sampler.confidence_groups = conf
        rows.append({
            "epoch": ep,
            "conf_mean": float(conf.mean()),
            "conf_per_class": [float(c) for c in conf.mean(axis=1)],
            "dist": distribution_report(sampler, class_names),
        })

    print("  | epoch | conf mean | class | entropy | top group | L1 vs size prior |")
    for line in report_rows(rows):
        print(f"  {line}")
    print("[3/5] asserting the distribution shifts with feedback ...")
    # the shift grows as confidences accumulate (epoch-1 feedback after one
    # epoch of training is small for weak classes), so the bar applies at
    # the last fed epoch; earlier epochs need a non-zero shift
    fed = rows[-1]["dist"]
    # empty reports would make every assertion below pass vacuously
    assert fed, "distribution_report produced no classes: nothing verified"
    for c, d in fed.items():
        l1 = d["l1_from_size_prior"]
        assert l1 > 0.05, f"{c}: sampling distribution did not shift (L1={l1})"
    early = {c: d["l1_from_size_prior"] for c, d in rows[1]["dist"].items()}
    assert early and all(v > 0 for v in early.values()), f"no epoch-1 feedback: {early}"
    if len(rows) > 2:
        moves = [float(np.abs(np.asarray(rows[1]["dist"][c]["prob"])
                              - np.asarray(rows[-1]["dist"][c]["prob"])).sum()) for c in fed]
        assert max(moves) > 0.01, "distribution frozen across epochs"

    print("[4/5] checkpoint -> resume: curriculum + sampler state survive ...")
    last_ep = max(ckpts)
    conf_before = checkpoint_confidences(ckpts[last_ep])
    train(train_argv(cfg_file, epochs + 1, out_dir, device))
    ckpts2 = epoch_checkpoints(out_dir)
    assert max(ckpts2) == epochs + 1, "resume did not continue"
    # the pre-resume epoch's file is untouched and the resumed epoch trained
    # on to finite confidences
    np.testing.assert_array_equal(conf_before, checkpoint_confidences(ckpts2[last_ep]))
    conf_new = checkpoint_confidences(ckpts2[epochs + 1])
    assert np.isfinite(conf_new).all()
    return {"rows": rows, "losses": losses, "last_epoch": last_ep, "conf_shape": conf_shape,
            "resumed_epoch": epochs + 1}


def write_report(result, out_dir, cfg_file, device):
    """``com_rehearsal.jsonl`` and ``com_rehearsal.md`` under ``out_dir``."""
    print("[5/5] writing artifacts ...")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows, losses, epochs = result["rows"], result["losses"], result["resumed_epoch"] - 1
    with open(out_dir / "com_rehearsal.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"losses": losses}) + "\n")
    lines = [
        "# COM feedback rehearsal",
        "",
        f"Config: `{Path(cfg_file).name}`, confidence tensor {result['conf_shape']}.  "
        f"{epochs}+1 epochs via `com_tpu_torch.tools.train` ({device}).  Reference "
        "contract: train_utils.py:321-328.",
        "",
        "## Loss curve (per logged step)",
        "",
        "| step | loss |", "|---|---|",
    ] + [f"| {s} | {l:.4f} |" for s, l in losses] + [
        "",
        "## Sampler distribution per epoch",
        "",
        "Epoch 0 samples from the database's size prior (no feedback yet); every later "
        "epoch re-weights groups through the Gaussian pacing window around the confidence "
        "quantile (ANTI=True: easiest first).",
        "",
        "| epoch | conf mean | class | entropy | top group | L1 vs size prior |",
        "|---|---|---|---|---|---|",
    ] + report_rows(rows) + [
        "",
        "## Resume check",
        "",
        f"Re-launched the train CLI with `--epochs {epochs + 1}` on the same output dir: the "
        f"resume restored the curriculum and sampler state (the epoch-{result['last_epoch']} "
        "checkpoint's confidences bitwise equal before and after), and the continued epoch "
        "produced finite confidences.",
    ]
    (out_dir / "com_rehearsal.md").write_text("\n".join(lines) + "\n")
    print(f"OK: wrote {out_dir / 'com_rehearsal.md'}")


def report_rows(rows):
    """The per-epoch table's rows: epoch, confidence mean, class, entropy,
    top group, L1 from the size prior."""
    out = []
    for r in rows:
        cm = "-" if r.get("conf_mean") is None else f"{r['conf_mean']:.4f}"
        for c, d in r["dist"].items():
            out.append(f"| {r['epoch']} | {cm} | {c} | {d['entropy']:.3f} | {d['top_group']} | "
                       f"{d['l1_from_size_prior']:.3f} |")
    return out


def main(argv=None, train=run_train):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--cfg",
                    default=str(REPO / "configs/synthetic_models/centerpoint_synth_com.yaml"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--output_dir", default=str(REPO / "output/com_rehearsal"))
    args = ap.parse_args(argv)
    result = rehearse(args.cfg, args.epochs, args.output_dir, args.device, train=train)
    write_report(result, args.output_dir, args.cfg, args.device)
    return result


if __name__ == "__main__":
    main()
