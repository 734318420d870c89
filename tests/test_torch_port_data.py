"""The port's real-image pipeline (`uaps_tpu_torch/data/augment.py`,
`specs.py`, `pipeline.py`), its Trainer run and the serve directory CLI
against the JAX package on the CPU.

The image sets are written by the test from numpy seeds at 40 x 40
(`write_image_set`): 48 train and 12 test images in NEU's layout (RGB
JPGs, PNG masks of classes 0-3), DAGM's (grey `.PNG`, no test
directory) and KolektorSDD2's (portrait 40 x 24 PNGs, masks of 0 / 255).
Both packages decode them with this machine's OpenCV, so JPEG decoding is
the same on both sides.

Tolerances: every augment op's images and masks, the splits and every
batch's labels bit-equal; the batches' images within 2e-6 absolute: JAX
normalises with its native library, s (1 / (255 std)) - mean / std
(uaps_tpu/native/host_ops.cc), the port with the numpy formula (x / 255
- mean) / std, which round apart by up to 4.8e-7 over every uint8 value
at neu's mean and std.
"""
import dataclasses
import json
import logging
import os

import jax  # noqa: F401 (imported before torch)
import numpy as np
import pytest

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from uaps_tpu.data import augment as JA
from uaps_tpu.data import pipeline as jpipe
from uaps_tpu.data import specs as jspecs
from uaps_tpu.utils.config import preset as jpreset
from uaps_tpu_torch.data import augment as PA
from uaps_tpu_torch.data import pipeline as ppipe
from uaps_tpu_torch.data import specs as pspecs
from uaps_tpu_torch.data.synthetic import write_image_set
from uaps_tpu_torch.utils.config import preset as ppreset

NORM_ATOL = 2e-6
# (dataset, train images, test images, (H, W), classes)
SETS = {"neu": ("neu", 48, 12, (40, 40), 4),
        "dagm": ("dagm", 48, 0, (40, 40), 7),
        "kosdd2": ("kosdd2", 48, 12, (40, 24), 2)}
PRESET = {"neu": "neu", "dagm": "dagm", "kosdd2": "kosdd2",
          "ucc_neu": "neu"}
NARROW = (4, 8, 16, 32, 64)


@pytest.fixture(scope="module")
def image_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    return {name: write_image_set(str(root / name), ds, n, nt, hw, c, seed=i)
            for i, (name, (ds, n, nt, hw, c)) in enumerate(SETS.items())}


def _data_cfgs(name, roots, batch_size=2, **kw):
    """The dataset's data config from each package's preset, on `roots`."""
    out = []
    for make in (jpreset, ppreset):
        d = make(PRESET[name]).data
        out.append(dataclasses.replace(
            d, name=name, batch_size=batch_size, num_workers=2, **roots,
            **kw))
    return out


# ------------------------------------------------------------- the ops
def _ops(m):
    """(name, op) of every augment op of module `m`, each at p = 1 (the
    probability draws still happen), and two recipes."""
    return [("resize", m.resize(30, 52)), ("hflip", m.hflip(1.0)),
            ("vflip", m.vflip(1.0)), ("rotate90", m.random_rotate90(1.0)),
            ("brightness_contrast",
             m.random_brightness_contrast(p=1.0)),
            ("blur", m.blur(1.0)), ("gauss_noise", m.gauss_noise(1.0)),
            ("grid_distortion", m.grid_distortion(1.0)),
            ("color_jitter", m.color_jitter(1.0)),
            ("pixel_dropout", m.pixel_dropout(1.0, dropout_prob=0.2)),
            ("neu_recipe", jspecs._neu_train() if m is JA
             else pspecs._neu_train()),
            ("ucc_strong_recipe", jspecs._ucc_strong() if m is JA
             else pspecs._ucc_strong())]


OP_NAMES = [n for n, _ in _ops(PA)]


@pytest.mark.parametrize("channels", ["rgb", "grey"])
@pytest.mark.parametrize("op", OP_NAMES)
def test_augment_ops_match_jax(op, channels):
    """Each op (and the neu and UCC-strong recipes) from one default_rng
    seed, 6 calls on a uint8 RGB or grey 40 x 36 image and its mask:
    images and masks bit-equal to JAX's op, and the generators left in the
    same state. `normalize` of the outputs bit-equal to JAX's numpy
    normalize."""
    rng = np.random.default_rng(3)
    shape = (40, 36, 3) if channels == "rgb" else (40, 36)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    mask = rng.integers(0, 4, shape[:2], dtype=np.uint8)
    jop, pop = (dict(_ops(m))[op] for m in (JA, PA))
    rj, rp = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(6):
        ji, jm = jop(rj, img, mask)
        pi, pm = pop(rp, img, mask)
        assert pi.dtype == ji.dtype == np.uint8
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pm, jm)
        mean, std = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)) \
            if pi.ndim == 3 else ((0.5314,), (0.1357,))
        np.testing.assert_array_equal(PA.normalize(pi, mean, std),
                                      JA.normalize(ji, mean, std))
    assert rp.random() == rj.random()


# ---------------------------------------------------------- the splits
@pytest.mark.parametrize("protocol", ["neu", "dagm", "valsplit"])
def test_split_ids_match_sklearn(protocol):
    """split_ids without sklearn against JAX's (sklearn's
    train_test_split) for n of 12, 48, 60, 1000 and 3085, labelled
    fractions 0.1 and 0.4 and val fractions 0.15 and 0.2, with and without
    a test directory: every split equal, in order; where sklearn raises
    ValueError for a side left empty (n 12 at 10% labelled, a labelled
    fraction of 1), so does the port."""
    spec = {"neu": "neu", "dagm": "dagm", "valsplit": "mtiles"}[protocol]
    raised = 0
    for n in (12, 48, 60, 1000, 3085):
        ids = [f"img{i:05d}" for i in range(n)]
        for lab in (0.1, 0.4, 1.0):
            for val in (0.15, 0.2):
                for test in (None, [f"t{i}" for i in range(5)]):
                    args = (ids, test, val, lab, 69, 45)
                    try:
                        want = jspecs.split_ids(jspecs.SPECS[spec], *args)
                    except ValueError:
                        raised += 1
                        with pytest.raises(ValueError):
                            pspecs.split_ids(pspecs.SPECS[spec], *args)
                        continue
                    got = pspecs.split_ids(pspecs.SPECS[spec], *args)
                    assert got == want, (n, lab, val, test)
    assert raised >= 5 * 2 * 2   # every lab = 1.0 case, and n 12's


# --------------------------------------------------------- the streams
def _first(it, n=2):
    return [next(it) for _ in range(n)]


def _check_batches(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in keys:
            if k.startswith("image") or k.startswith("uimage"):
                assert g[k].dtype == np.float32, k
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=NORM_ATOL, err_msg=k)
            else:
                assert g[k].dtype == np.int32, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("name", ["neu", "ucc_neu", "dagm", "kosdd2"])
def test_streams_match_jax(image_sets, name):
    """DefectDataset with one seed in both packages: the splits, the first
    2 batches of train_iter (train_iter_weak_strong for ucc_neu, with the
    strong view), val_iter and test_iter (the dedicated test directory
    for neu and kosdd2, the split's test ids for dagm) and their shapes:
    neu 256 x 256 x 3, dagm 256 x 256 x 1, kosdd2 256 x 512 landscape
    with 0/1 labels; labels bit-equal, images within NORM_ATOL."""
    roots = image_sets["neu" if name == "ucc_neu" else name]
    jcfg, pcfg = _data_cfgs(name, roots)
    jd, pd = jpipe.DefectDataset(jcfg, seed=7), ppipe.DefectDataset(pcfg, 7)
    assert pd.splits == jd.splits
    if name == "ucc_neu":
        it = (d.train_iter_weak_strong() for d in (jd, pd))
        keys = ("image", "label", "uimage", "ulabel", "uimage_strong")
    else:
        it = (d.train_iter() for d in (jd, pd))
        keys = ("image", "label", "uimage", "ulabel")
    want, got = (_first(i) for i in it)
    _check_batches(got, want, keys)
    hw, c, classes = {"neu": ((256, 256), 3, 4), "ucc_neu": ((256, 256), 3, 4),
                      "dagm": ((256, 256), 1, 7),
                      "kosdd2": ((256, 512), 3, 2)}[name]
    for b in got:
        assert b["image"].shape == (2, *hw, c)
        assert b["label"].shape == (2, *hw)
        assert 0 <= b["label"].min() and b["label"].max() < classes
    for sweep in ("val_iter", "test_iter"):
        want, got = (_first(getattr(d, sweep)()) for d in (jd, pd))
        _check_batches(got, want, ("image", "label"))
    if name == "kosdd2":
        assert {int(v) for b in got for v in np.unique(b["label"])} == {0, 1}


def test_make_data_and_small_splits(image_sets):
    """make_data: ucc on neu reads the files through ucc_neu's recipe (JAX
    train.py:45-48), uaps through neu's; without an image root it raises
    JAX's ValueError; a labelled split smaller than the batch raises
    (JAX's producer would loop without a batch)."""
    from uaps_tpu_torch import train
    for method, spec in (("ucc", "ucc_neu"), ("uaps", "neu")):
        cfg = ppreset("neu", method=method)
        cfg.data = dataclasses.replace(cfg.data, **image_sets["neu"])
        assert train.make_data(cfg).spec.name == spec
    cfg = ppreset("neu")
    cfg.data = dataclasses.replace(cfg.data, image_root="")
    with pytest.raises(ValueError, match="image_root"):
        train.make_data(cfg)
    _, pcfg = _data_cfgs("neu", image_sets["neu"], batch_size=5)
    with pytest.raises(ValueError, match="labeled split"):
        next(ppipe.DefectDataset(pcfg).train_iter())


# ------------------------------------------------ the Trainer, the CLIs
def _narrow(monkeypatch):
    """unet_uaps at NARROW widths (one aux decoder) wherever the port
    builds it."""
    from uaps_tpu_torch.models import factory, unet

    def make(num_classes, in_chns, dtype, n_aux=1, **kw):
        return unet.MultiDecoderUNet(num_classes, ("feature_noise",) * n_aux,
                                     in_chns, dtype, features=NARROW, **kw)

    monkeypatch.setitem(factory.MODEL_REGISTRY, "unet_uaps", make)


def _run_cfg(image_sets, out, **run_kw):
    cfg = ppreset("neu", method="uaps")
    cfg.data = dataclasses.replace(cfg.data, batch_size=3, num_workers=2,
                                   **image_sets["neu"])
    cfg.model = dataclasses.replace(cfg.model, n_aux=1)
    cfg.run = dataclasses.replace(cfg.run, epochs=1, iter_per_epoch=2,
                                  out_dir=str(out), **run_kw)
    return cfg


def test_trainer_runs_on_image_files(image_sets, tmp_path, monkeypatch,
                                     caplog):
    """Trainer.run on the neu files (uaps, a narrow unet_uaps, B = 3): 1
    epoch of 2 steps from the host stream (device_pools asked for: it
    warns and trains from the stream, as JAX), the metrics line, a
    checkpoint and best_model.pth, and a val sweep over the 8 val images
    whose last batch is short (3, 3, 2)."""
    from uaps_tpu_torch import train
    _narrow(monkeypatch)
    cfg = _run_cfg(image_sets, tmp_path, device_pools=True)
    with caplog.at_level(logging.WARNING, logger="uaps"):
        t = train.Trainer(cfg, device="cpu")
    assert t.pools is None and "host stream" in caplog.text
    sizes = []
    val_iter = t.data.val_iter

    def recorded():
        for b in val_iter():
            sizes.append(len(b["image"]))
            yield b

    t.data.val_iter = recorded
    best = t.run()
    assert sizes == [3, 3, 2]
    (line,) = (tmp_path / "metrics.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert rec["step"] == 1 and best == rec["val_mdice"]
    assert np.isfinite([rec[k] for k in ("loss", "sup_loss", "val_loss",
                                         "val_mdice")]).all()
    assert t.ckpt.steps() == [2]
    assert (tmp_path / "best_model.pth").exists()


@pytest.mark.parametrize("fault", ["small labeled split", "missing masks"])
def test_trainer_raises_pipeline_faults(image_sets, tmp_path, monkeypatch,
                                        fault):
    """A fault of the image stream, raised on its producer threads, stops
    Trainer.run with that error instead of leaving it waiting on the
    stream: a labelled split smaller than the batch (B = 5) raises
    ValueError, a mask directory without the masks FileNotFoundError. The
    run goes on a thread of its own, so that a hang fails the test."""
    import threading
    from uaps_tpu_torch import train
    _narrow(monkeypatch)
    cfg = _run_cfg(image_sets, tmp_path)
    if fault == "small labeled split":
        cfg.data = dataclasses.replace(cfg.data, batch_size=5)
        want, match = ValueError, "labeled split"
    else:
        (tmp_path / "no_masks").mkdir()
        cfg.data = dataclasses.replace(cfg.data,
                                       mask_root=str(tmp_path / "no_masks"))
        want, match = FileNotFoundError, "missing image/mask"
    t = train.Trainer(cfg, device="cpu")
    raised = []

    def run():
        try:
            t.run()
        except Exception as e:   # noqa: BLE001 (checked below)
            raised.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(120)
    assert not th.is_alive(), "Trainer.run hung on a fault of the stream"
    (err,) = raised
    assert isinstance(err, want) and match in str(err), err


def test_serve_directory_cli(image_sets, tmp_path, monkeypatch):
    """`python -m uaps_tpu_torch.serve --images DIR --out DIR
    --torch_ckpt PTH --uncertainty --device cpu` on 5 test images: the
    masks it writes equal InferenceEngine.predict of the same decoded
    batch, the viz is the palette of the masks, an uncertainty PNG an
    image, the count printed; with --export it writes the artifact
    instead (artifact.py) and returns its size."""
    import shutil
    from uaps_tpu_torch import serve
    from uaps_tpu_torch.methods import base
    from uaps_tpu_torch.utils.viz import colorize
    from uaps_tpu_torch.utils.weights import save_pth
    cv2 = PA.cv2()
    _narrow(monkeypatch)
    src = tmp_path / "in"
    src.mkdir()
    test_dir = image_sets["neu"]["test_image_root"]
    for n in sorted(os.listdir(test_dir))[:5]:
        shutil.copy(os.path.join(test_dir, n), src / n)
    (src / "notes.txt").write_text("not an image")
    cfg = _run_cfg(image_sets, tmp_path)
    pth = str(tmp_path / "m.pth")
    save_pth(base.build_model(cfg, "cpu"), pth)
    argv = ["--preset", "neu", "--method", "uaps", "--n_aux", "1",
            "--torch_ckpt", pth, "--device", "cpu", "--images", str(src),
            "--out", str(tmp_path / "out"), "--uncertainty"]
    res = serve.main(argv)
    assert res["images"] == 5
    names, batch = serve.read_images(str(src), (256, 256))
    engine = serve.InferenceEngine.from_torch(cfg, pth, device="cpu")
    masks, _ = engine.predict(batch)
    for n, m in zip(names, masks):
        stem = os.path.splitext(n)[0]
        got = cv2.imread(str(tmp_path / "out" / f"{stem}_mask.png"),
                         cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, m)
        viz = cv2.cvtColor(cv2.imread(str(tmp_path / "out"
                                          / f"{stem}_viz.png")),
                           cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(viz, colorize(m))
        assert (tmp_path / "out" / f"{stem}_uncert.png").exists()
    res = serve.main(argv + ["--export", str(tmp_path / "x")])
    from uaps_tpu_torch import artifact
    meta, _ = artifact.read(str(tmp_path / "x"))
    assert (tmp_path / "x").stat().st_size == res["bytes"]
    assert (meta["image_size"], meta["device"]) == ([256, 256], "cpu")
