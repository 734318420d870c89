"""The port's eval CLI (`uaps_tpu_torch/eval.py`), `per_class_iou`,
`flip_tta_softmax` and the engine's TTA against the JAX package on the
CPU.

`evaluate` is held to JAX's `evaluate` on the same weights: seeded f32
variables go into a JAX TrainState saved with JAX's manager and, through
`load_jax_params`, into the port's model saved with the port's manager;
both score the synthetic test split (8 images, 32 x 32, batch 1) with
the main decoder. JAX's `evaluate` builds its state's structure with the
method's `init_state`, whose `model.init` takes ~70 CPU-s here; the test
hands it a state of the same structure built from the seeded variables
(`seeded_variables` traces the shapes in ~1 s). Tolerance: the metrics
and the per-class IoU within 1e-6 (the two f32 forwards differ by ~1e-6,
which flips no argmax here), `num_images` equal. The PNGs the port writes
are read back with cv2 and held equal to cv2's own rendering of the same
maps: the prediction and the ground truth in the palette, the first
image's uncertainty map in JET (its perturbations come from torch's
generator, so it is not JAX's map).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import seeded_variables
from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from uaps_tpu.utils.config import preset as jpreset
from uaps_tpu_torch import eval as peval
from uaps_tpu_torch.methods import get_method
from uaps_tpu_torch.ops import per_class_iou
from uaps_tpu_torch.ops.tta import flip_tta_softmax
from uaps_tpu_torch.utils import viz
from uaps_tpu_torch.utils.checkpoint import CheckpointManager, state_tensors
from uaps_tpu_torch.utils.config import preset
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (32, 32)


def _cfgs(method="uaps"):
    out = []
    for make in (jpreset, preset):
        cfg = make("synthetic", method=method)
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=4)
        if method == "uaps":
            cfg.model = dataclasses.replace(cfg.model, n_aux=1)
        out.append(cfg)
    return out


def _class_lines(text):
    return [float(v) for v in re.findall(r"class_\d+_IoU: ([0-9.]+)",
                                         text)]


def test_evaluate_matches_jax(tmp_path, capsys, monkeypatch):
    """The port's evaluate on a run dir against JAX's evaluate on the same
    weights: mIoU, mDice, pixel accuracy, per-class IoU and num_images;
    the visualisations as cv2 reads them; TTA runs."""
    import cv2
    from uaps_tpu.eval import evaluate as jevaluate
    from uaps_tpu.methods import base as jbase
    from uaps_tpu.methods import get_method as jget_method
    from uaps_tpu.utils.checkpoint import CheckpointManager as JaxManager
    from uaps_tpu_torch.serve import uncertainty_map
    from uaps_tpu_torch.train import make_data
    jcfg, pcfg = _cfgs()
    jmodel = jbase.build_model(jcfg)
    v = seeded_variables(jmodel, HW, 21)
    jstate = jbase.TrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"],
        opt_state=jbase.make_optimizer(jcfg.optim).init(v["params"]),
        key=jax.random.key(0))
    monkeypatch.setattr(jget_method("uaps"), "init_state",
                        lambda cfg, rng: (jstate, jmodel))
    jm = JaxManager(str(tmp_path / "jax" / "checkpoints"))
    jm.save(7, jstate, host_state={"epoch": 1},
            metrics={"val_mdice": 0.5})
    jm.wait()
    jm.close()
    jres = jevaluate(jcfg, str(tmp_path / "jax"))
    jtext = capsys.readouterr().out

    state, model = get_method("uaps").init_state(pcfg, "cpu")
    load_jax_params(model, v["params"], v["batch_stats"])
    CheckpointManager(str(tmp_path / "port" / "checkpoints")).save(
        7, state_tensors(state, model), {"epoch": 1}, {"val_mdice": 0.5})
    pres = peval.evaluate(pcfg, str(tmp_path / "port"),
                          save_viz=str(tmp_path / "viz"), device="cpu")
    ptext = capsys.readouterr().out

    assert pres["num_images"] == jres["num_images"] == 8
    for k in ("miou", "mdice", "pixel_acc"):
        np.testing.assert_allclose(pres[k], jres[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    jclass = _class_lines(jtext)
    assert len(jclass) == 3
    np.testing.assert_allclose(_class_lines(ptext), jclass, atol=0)
    np.testing.assert_allclose(pres["class_iou"][1:], jclass, atol=5e-5)
    assert all(np.isfinite(pres[k]) for k in ("p50_latency_ms",
                                              "p99_latency_ms"))
    model.eval()
    for i, batch in enumerate(make_data(pcfg, pcfg.run.seed).test_iter(
            batch_size=1)):
        image = torch.from_numpy(batch["image"])
        with torch.inference_mode():
            pred = torch.argmax(model.main_only(image)[0], -1).numpy()
        want = {"pred": viz.colorize(pred)[..., ::-1],
                "gt": viz.colorize(batch["label"][0])[..., ::-1]}
        if i == 0:
            umap = uncertainty_map(model, image)[0].numpy()
            assert umap.max() > 0
            umap = (255 * umap / umap.max()).astype(np.uint8)
            want["uncert"] = cv2.applyColorMap(umap, cv2.COLORMAP_JET)
        for kind, png in want.items():
            name = f"{i:03d}_{kind}.png"
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "viz" / name)), png,
                err_msg=name)
    assert (tmp_path / "viz" / "007_uncert.png").exists()

    # TTA scores the flips' mean softmax: its metrics near the plain ones
    tres = peval.evaluate(pcfg, str(tmp_path / "port"), tta=True,
                          device="cpu")
    assert tres["num_images"] == 8
    assert abs(tres["pixel_acc"] - pres["pixel_acc"]) < 0.1


@pytest.mark.parametrize("case", ["model2", "ema", "missing"])
def test_evaluate_errors(tmp_path, case):
    """JAX's errors: --model2 on a method with no net 2, --eval_ema on a
    method with no teacher (ValueError), no checkpoint
    (FileNotFoundError)."""
    _, cfg = _cfgs("baseline")
    if case == "missing":
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            peval.evaluate(cfg, str(tmp_path / "nope"), device="cpu")
        return
    with pytest.raises(ValueError, match="--model2" if case == "model2"
                       else "--eval_ema"):
        peval.evaluate(cfg, str(tmp_path), which=case, device="cpu")


def test_per_class_iou_matches_jax():
    """per_class_iou against JAX's on random logits with an absent class
    (NaN there, background included)."""
    from uaps_tpu.ops.metrics import per_class_iou as jiou
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    label = rng.integers(0, 4, (2, 9, 11)).astype(np.int32)   # no class 4
    want = np.asarray(jiou(jnp.asarray(logits), jnp.asarray(label), 5))
    got = per_class_iou(torch.from_numpy(logits), torch.from_numpy(label),
                        5).numpy()
    assert np.isnan(want[4]) and np.isnan(got[4])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_flip_tta_softmax_matches_jax():
    """flip_tta_softmax against JAX's on a forward that no flip leaves
    alone (a channel mix, then a cumulative sum down H and a ramp across
    W)."""
    from uaps_tpu.ops.tta import flip_tta_softmax as jtta
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    ramp = np.linspace(0, 1, 7, dtype=np.float32)[None, None, :, None]

    def jfwd(variables, img):
        return jnp.cumsum(img @ variables, axis=1) * ramp

    def tfwd(img):
        return torch.cumsum(img @ torch.from_numpy(w), dim=1) * \
            torch.from_numpy(ramp)

    want = np.asarray(jtta(jfwd, jnp.asarray(w), jnp.asarray(x)))
    got = flip_tta_softmax(tfwd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_viz_png_and_jet_match_cv2(tmp_path):
    """JET equals cv2's COLORMAP_JET at every uint8 value, and write_png's
    files read back in cv2 as the arrays written (odd sizes)."""
    import cv2
    values = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(viz.jet(values),
                                  cv2.applyColorMap(values,
                                                    cv2.COLORMAP_JET)[...,
                                                                      ::-1])
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (5, 9, 3)).astype(np.uint8)
    viz.write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png")),
                                  rgb[..., ::-1])
    mask = rng.integers(0, 9, (3, 4))
    np.testing.assert_array_equal(viz.colorize(mask),
                                  viz.PALETTE[np.clip(mask, 0, 6)])
