"""The port's deployable artifact (uaps_tpu_torch/artifact.py,
`InferenceEngine.export`, `ExportedEngine`, `serve --export`) and the
kernels' `uaps::` operators (uaps_tpu_torch/kernels/custom_ops.py) on the
CPU, where the operators run the kernels' plain versions.

The round trips follow the JAX package's TestExport (tests/test_serve.py):
the synthetic unet_uaps at 32 x 32, batch 4, 5 uint8 images (the second
micro-batch padded): the masks equal and the probs within 1e-6 (the
artifact normalises uint8 as (x - 255 mean) / (255 std), JAX's
ExportedEngine formula, the live engine as (x / 255 - mean) / std: a few
f32 ulps apart at the input).
"""
import dataclasses
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from uaps_tpu_torch import artifact
from uaps_tpu_torch.kernels import custom_ops
from uaps_tpu_torch.methods.base import build_model
from uaps_tpu_torch.serve import ExportedEngine, InferenceEngine, main
from uaps_tpu_torch.utils.config import preset
from uaps_tpu_torch.utils.weights import save_pth

REPO = Path(__file__).resolve().parent.parent
HW = (32, 32)
JAX_KEYS = ("batch_size", "image_size", "in_channels", "mean", "std",
            "num_classes", "model")


def _cfg(method="uaps", model=None, hw=HW, batch=4, name="synthetic"):
    cfg = preset(name, method=method)
    cfg.data = dataclasses.replace(cfg.data, image_size=hw, batch_size=batch)
    if model:
        cfg.model = dataclasses.replace(cfg.model, name=model)
    return cfg


def _engine(cfg, tta=False, seed=0):
    sd = build_model(cfg, "cpu", torch.Generator().manual_seed(seed)
                     ).state_dict()
    return InferenceEngine(cfg, state_dict=sd, device="cpu", tta=tta)


def _images(n=5, hw=HW, seed=2):
    return np.random.default_rng(seed).integers(0, 255, (n, *hw, 3)
                                                ).astype(np.uint8)


def _roundtrip(eng, path):
    eng.export(str(path))
    loaded = ExportedEngine(str(path), device="cpu")
    imgs = _images()
    m1, p1 = eng.predict(imgs)
    m2, p2 = loaded.predict(imgs)
    assert m2.dtype == np.int32 and p2.dtype == np.float32
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=1e-6)
    return loaded


@pytest.fixture(scope="module")
def uaps_artifact(tmp_path_factory):
    """(path, loaded engine) of the synthetic unet_uaps artifact, held to
    its live engine."""
    path = tmp_path_factory.mktemp("export") / "uaps.export"
    return path, _roundtrip(_engine(_cfg()), path)


def test_export_roundtrip_matches_engine(uaps_artifact):
    """The port's version of JAX's TestExport: unet_uaps, 32 x 32, batch 4,
    5 uint8 images through the normalisation and the padding micro-batcher
    (the fixture); the header holds the device and dtype it was exported
    with and the operators' module."""
    _, loaded = uaps_artifact
    assert loaded.meta["num_classes"] == 4
    assert loaded.meta["device"] == "cpu"
    assert loaded.meta["dtype"] == "float32"
    assert loaded.meta["ops_module"] == custom_ops.__name__


def test_header_matches_jax_export(uaps_artifact, tmp_path):
    """Every key JAX's export writes, with JAX's value, for the same
    config. JAX's `InferenceEngine.export` writes the header from the
    config and batch size alone; it runs here on an engine whose predictor
    is a stand-in (building JAX's engine inits the model, ~30 CPU-s), so
    its program is not the model's, only its header is compared."""
    import jax.numpy as jnp
    from uaps_tpu.serve import InferenceEngine as JaxEngine
    from uaps_tpu.utils.config import preset as jax_preset
    jeng = JaxEngine.__new__(JaxEngine)
    jeng.cfg = jax_preset("synthetic", method="uaps")
    jeng.cfg.data = dataclasses.replace(jeng.cfg.data, image_size=HW,
                                        batch_size=4)
    jeng.batch_size = 4
    jeng.params = jeng.batch_stats = {}
    jeng._predict = lambda params, stats, x: (
        jnp.argmax(x, -1).astype(jnp.int32), x)
    jeng.export(str(tmp_path / "jax.export"))
    want, _ = artifact.read(str(tmp_path / "jax.export"))
    got, _ = artifact.read(str(uaps_artifact[0]))
    assert set(want) == set(JAX_KEYS)
    for k in JAX_KEYS:
        assert got[k] == want[k], k


@pytest.mark.parametrize("model", [None, "basenet_resnet18"])
def test_tta_artifacts_match_engines(tmp_path, model):
    """The flip-TTA unet_uaps engine and the basenet_resnet18 engine with
    its multi-scale flip TTA (probs: the sum divided by its class sum)."""
    cfg = _cfg("baseline" if model else "uaps", model)
    _roundtrip(_engine(cfg, tta=True), tmp_path / "tta.export")


def test_loader_imports_no_model_or_config(uaps_artifact):
    """A fresh interpreter loads an artifact and predicts with torch and the
    operators' module: no jax, no uaps_tpu, and no port model, method,
    config or data module in sys.modules."""
    code = (
        "import sys, numpy as np\n"
        "from uaps_tpu_torch.artifact import ExportedEngine\n"
        f"eng = ExportedEngine({str(uaps_artifact[0])!r}, device='cpu')\n"
        "m, p = eng.predict(np.zeros((5, 32, 32, 3), np.uint8))\n"
        "assert m.shape == (5, 32, 32) and p.shape == (5, 32, 32, 4)\n"
        "bad = ('uaps_tpu_torch.models', 'uaps_tpu_torch.methods',\n"
        "       'uaps_tpu_torch.utils', 'uaps_tpu_torch.data',\n"
        "       'uaps_tpu_torch.serve')\n"
        "hit = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'uaps_tpu') or n.startswith(bad)]\n"
        "assert not hit, hit\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


class _OpCalls(TorchDispatchMode):
    """Counts the `uaps::` operator calls under it."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == custom_ops.NAMESPACE:
            self.n[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def test_exported_graph_calls_the_ops(tmp_path):
    """At 128 x 128, the smallest size where the gates route a conv and a
    pool to the kernels (level 0: the in_conv's and up4's convs and the
    head; the pool into level 1), the exported program of the neu unet_uaps
    calls `uaps::conv3x3_nchw` and `uaps::max_pool_2x2_nchw` as many times
    as the live forward does, once per gated conv and pool."""
    eng = _engine(_cfg(name="neu", hw=(128, 128), batch=1))
    x = torch.zeros((1, 128, 128, 3))
    with _OpCalls() as live:
        eng.predict_device(x)
    eng.export(str(tmp_path / "neu.export"))
    _, blob = artifact.read(str(tmp_path / "neu.export"))
    import io
    program = torch.export.load(io.BytesIO(blob))
    nodes = Counter(n.target.__name__.split(".")[0]
                    for n in program.graph.nodes
                    if n.op == "call_function"
                    and getattr(n.target, "namespace", "") == "uaps")
    assert live.n == {"conv3x3_nchw": 5, "max_pool_2x2_nchw": 1}
    assert nodes == live.n


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    x, w = r(2, 3, 8, 16), r(3, 3, 3, 4)
    y, f, s, w4 = r(2, 4, 8, 16), r(4), r(4), r(3, 3, 4, 5)
    seed = torch.tensor(12345)
    ops = torch.ops.uaps
    return [
        (ops.conv3x3_nchw, (x, w, torch.float32)),
        (ops.conv3x3_nchw, (x.bfloat16(), w.bfloat16(), torch.float32)),
        (ops.conv3x3_nchw_fullh, (x, w)),
        (ops.conv3x3_nchw_stats, (x, w)),
        (ops.max_pool_2x2_nchw, (x,)),
        (ops.conv3x3_bnl, (y, f, s, w4, torch.float32)),
        (ops.chain_conv_plain, (x, w)),
        (ops.chain_conv_bnl, (y, f, s, w4, None, 0.0)),
        (ops.chain_conv_bnl, (y, f, s, w4, seed, 0.25)),
        (ops.conv3x3_nhwc, (x.permute(0, 2, 3, 1).contiguous(), w)),
    ]


@pytest.mark.parametrize("case", range(10))
def test_opcheck(case):
    """torch.library.opcheck on every operator at a small CPU shape: the
    schema, the fake implementation against the CPU one, and the
    operator under AOT dispatch."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op.default, args)


def test_serve_main_export(tmp_path):
    """`serve --export PATH` writes the artifact, prints its path and size
    and returns without --images / --out."""
    cfg = _cfg(hw=(64, 64))
    pth = tmp_path / "model.pth"
    save_pth(build_model(cfg, "cpu", torch.Generator().manual_seed(0)), pth)
    out = tmp_path / "cli.export"
    res = main(["--preset", "synthetic", "--method", "uaps", "--batch_size",
                "2", "--torch_ckpt", str(pth), "--export", str(out),
                "--device", "cpu"])
    assert out.stat().st_size == res["bytes"]
    meta, _ = artifact.read(str(out))
    assert (meta["batch_size"], meta["image_size"]) == (2, [64, 64])
