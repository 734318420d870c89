"""Evaluation CLI: the port's `uaps_tpu/eval.py` (the notebooks' test
protocol).

    python -m uaps_tpu_torch.eval --preset neu --method uaps \
        --ckpt RUN_DIR [--split test|val] [--save_viz DIR] [--latest] \
        [--model2 | --eval_ema] [--tta] [--device cuda]

The data is the synthetic fixture (`--dataset synthetic`) or image files
(data/pipeline.py): the test split is the dedicated test directory
(`--test_image_root`, `--test_mask_root`) where the dataset has one, else
the ids the split protocol sets aside; `--split val` is the val split, its
last batch short. Each image is predicted at batch 1 (the val split at
the data's batch) through the main decoder (`main_only`; a
deep-supervision net's dp0),
scored with `segmentation_metrics` and `per_class_iou`, and the means over
the images are returned with the p50 / p99 latency after the first image
(host clock around the prediction and its copy to the host, which
synchronises) and the per-class IoU table printed. The weights are a
checkpoint of the port's Trainer (utils/checkpoint.py), the best by val
mDice unless `--latest`: net 1, cps's net 2 (`--model2`) or mt's / uamt's
teacher (`--eval_ema`). `--save_viz` writes up to 16 triples of PNGs: the
prediction and the ground truth in the NEU palette, and the uncertainty
map (the main decoder's KL from the decoders' mean, scaled to 255) in
JET (utils/viz.py: no OpenCV). `--tta` scores the mean softmax over the 4
H/V flips (ops/tta.py); a BaseNet scores its multi-scale flip sum
(models/resnet.py; JAX eval.py:101-102). Runs on `cuda` unless `--device
cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from uaps_tpu_torch.methods import base, get_method
from uaps_tpu_torch.ops import per_class_iou, segmentation_metrics
from uaps_tpu_torch.ops.tta import flip_tta_softmax
from uaps_tpu_torch.serve import uncertainty_map
from uaps_tpu_torch.train import make_data
from uaps_tpu_torch.utils import viz
from uaps_tpu_torch.utils.checkpoint import load_module, restore_run
from uaps_tpu_torch.utils.cli import parse_args

MAX_VIZ = 16


def _weights(cfg, state, model, which: str):
    """(module to score, its checkpoint prefix) for `which`."""
    if which == "model2":
        if state.second is None:
            raise ValueError(
                f"--model2: method {cfg.method.name!r} carries no second "
                "model state (only CPS does)")
        return state.second.model, "second.model"
    if which == "ema":
        if state.ema_model is None:
            raise ValueError(
                f"--eval_ema: method {cfg.method.name!r} carries no EMA "
                "teacher (only MT/UAMT do)")
        return state.ema_model, "ema_model"
    return model, "model"


def evaluate(cfg, ckpt_dir: str, split: str = "test", save_viz: str = "",
             use_best: bool = True, which: str = "model1",
             tta: bool = False, device="cuda") -> Dict[str, float]:
    """The means of miou, mdice and pixel_acc over the split's images,
    p50_latency_ms, p99_latency_ms, num_images and class_iou (the
    per-class IoU averaged over the images holding the class, background
    included; NaN for a class no image holds). `ckpt_dir` is a run
    directory or its `checkpoints/`."""
    dev = base.resolve_device(device)
    state, model = get_method(cfg.method.name).init_state(cfg, dev)
    net, prefix = _weights(cfg, state, model, which)
    tensors, step, ckpt_dir = restore_run(ckpt_dir, use_best)
    load_module(net, tensors, prefix)
    net.eval()
    print(f"loaded checkpoint step {step} from {ckpt_dir}")
    forward = getattr(net, "main_only", net)
    n_classes = cfg.data.num_classes

    basenet = cfg.model.name.startswith("basenet")

    def predict(image):
        """Class scores [B, H, W, C]: logits, or under TTA the flips' mean
        softmax (a BaseNet: its multi-scale flip sum)."""
        with torch.inference_mode():
            if tta and basenet:
                return net(image, tta=True)
            if tta:
                return flip_tta_softmax(forward, image)
            return forward(image)

    data = make_data(cfg, seed=cfg.run.seed)
    it = (data.test_iter(batch_size=1) if split == "test"
          else data.val_iter())
    sums: Dict[str, float] = {}
    class_iou_sum = np.zeros(n_classes)
    class_iou_count = np.zeros(n_classes)
    latencies: List[float] = []
    n = 0
    if save_viz:
        os.makedirs(save_viz, exist_ok=True)
    for batch in it:
        image = torch.from_numpy(np.ascontiguousarray(
            batch["image"], np.float32)).to(dev)
        label = torch.from_numpy(np.ascontiguousarray(
            batch["label"], np.int32)).to(dev)
        t0 = time.perf_counter()
        scores = predict(image)
        scores_host = scores.cpu()      # a synchronising copy
        latencies.append(time.perf_counter() - t0)
        m = segmentation_metrics(scores, label, n_classes)
        ciou = per_class_iou(scores, label, n_classes).cpu().numpy()
        present = ~np.isnan(ciou)
        class_iou_sum[present] += ciou[present]
        class_iou_count[present] += 1
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        if save_viz and n < MAX_VIZ:
            pred = torch.argmax(scores_host[0], dim=-1).numpy()
            viz.write_png(os.path.join(save_viz, f"{n:03d}_pred.png"),
                          viz.colorize(pred))
            viz.write_png(os.path.join(save_viz, f"{n:03d}_gt.png"),
                          viz.colorize(batch["label"][0]))
            umap = uncertainty_map(net, image)[0].cpu().numpy()
            umap = (255 * umap / max(umap.max(), 1e-8)).astype(np.uint8)
            viz.write_png(os.path.join(save_viz, f"{n:03d}_uncert.png"),
                          viz.jet(umap))
        n += 1

    results: Dict = {k: v / max(n, 1) for k, v in sums.items()}
    lat = np.asarray(latencies[1:] or latencies)   # drop the first call
    results["p50_latency_ms"] = float(np.percentile(lat, 50) * 1000)
    results["p99_latency_ms"] = float(np.percentile(lat, 99) * 1000)
    results["num_images"] = n
    with np.errstate(invalid="ignore"):
        results["class_iou"] = (class_iou_sum / class_iou_count).tolist()

    try:
        from tabulate import tabulate
        rows = [["mIoU", f"{100 * results['miou']:.2f}%"],
                ["mDice", f"{100 * results['mdice']:.2f}%"],
                ["Pixel Acc", f"{100 * results['pixel_acc']:.2f}%"],
                ["p50 latency", f"{results['p50_latency_ms']:.2f} ms"],
                ["images", n]]
        print(tabulate(rows, headers=["metric", "value"]))
    except ImportError:
        print(json.dumps({k: v for k, v in results.items()
                          if k != "class_iou"}, indent=2))
    print("per-class IoU (classes 1..C-1, averaged over images where "
          "the class is present):")
    for c in range(1, n_classes):
        denom = max(class_iou_count[c], 1)
        print(f"  class_{c}_IoU: {class_iou_sum[c] / denom:.4f}")
    return results


def main(argv=None):
    cfg, _ = parse_args(argv)
    # no abbreviations: the config's `--model NAME` is not `--model2`
    # (JAX's eval CLI reads it as `--model2`)
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--split", default="test", choices=["test", "val"])
    p.add_argument("--save_viz", default="")
    p.add_argument("--latest", action="store_true")
    p.add_argument("--model2", action="store_true",
                   help="evaluate the CPS second net")
    p.add_argument("--eval_ema", action="store_true",
                   help="evaluate the MT/UAMT EMA teacher weights")
    p.add_argument("--tta", action="store_true",
                   help="mean softmax over the 4 H/V flips (a BaseNet: its "
                        "multi-scale flip sum)")
    p.add_argument("--device", default="cuda")
    extra, _ = p.parse_known_args(argv)
    which = ("model2" if extra.model2
             else ("ema" if extra.eval_ema else "model1"))
    ckpt_dir = extra.ckpt or os.path.join(cfg.run.out_dir, "checkpoints")
    return evaluate(cfg, ckpt_dir, split=extra.split,
                    save_viz=extra.save_viz, use_best=not extra.latest,
                    which=which, tta=extra.tta, device=extra.device)


if __name__ == "__main__":
    main()
