"""The port's serving path on the CPU: InferenceEngine.predict against the
JAX computation of uaps_tpu/serve.py (softmax + argmax over main_only), the
port's AsyncBatcher and HTTP front, the .pth hand-off, the port's copies of
the JAX package's config tree and weight mapping, the enum table, and the
rule that the port imports nothing of uaps_tpu, jax, flax, optax or
orbax."""
import ast
import dataclasses
import io
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import jit, neu_config, seeded_variables
from uaps_tpu import native
from uaps_tpu.methods.base import build_model as jax_build_model
from uaps_tpu.utils.config import preset
from uaps_tpu_torch.methods.base import build_model
from uaps_tpu_torch.ops.tta import flip_tta_softmax
from uaps_tpu_torch.serve import ExportedEngine, InferenceEngine
from uaps_tpu_torch.server import AsyncBatcher, serve_http
from uaps_tpu_torch.utils.weights import load_pth, state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
HW = (64, 64)
FORBIDDEN = {"uaps_tpu", "jax", "jaxlib", "flax", "optax", "orbax",
             "sklearn"}


@pytest.fixture(scope="module")
def served():
    """(cfg, JAX model, its seeded variables, port state dict)."""
    cfg = neu_config("uaps", "float32")
    jm = jax_build_model(cfg)
    variables = seeded_variables(jm, HW, 21)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return cfg, jm, variables, sd


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *HW, 3), dtype=np.uint8)


def test_predict_matches_jax_serve(served):
    """N=5 at batch 4: two micro-batches, the second padded."""
    cfg, jm, variables, sd = served
    engine = InferenceEngine(cfg, state_dict=sd, batch_size=4, device="cpu")
    imgs = _images(5, 1)
    masks, probs = engine.predict(imgs)

    @jit
    def jax_predict(v, x):    # uaps_tpu/serve.py _predict, no TTA
        p = jax.nn.softmax(jm.apply(v, x, train=False,
                                    method=jm.main_only), axis=-1)
        return jnp.argmax(p, axis=-1).astype(jnp.int32), p

    x = native.normalize_batch(imgs, cfg.data.mean, cfg.data.std)
    x = np.concatenate([x, np.repeat(x[-1:], 3, axis=0)])
    ref_m, ref_p = jax_predict(variables, jnp.asarray(x))
    assert masks.dtype == np.int32 and masks.shape == (5, *HW)
    assert probs.dtype == np.float32 and probs.shape == (5, *HW, 4)
    np.testing.assert_allclose(probs, np.asarray(ref_p)[:5], atol=1e-5)
    np.testing.assert_array_equal(masks, np.asarray(ref_m)[:5])
    # the port normalises with the JAX package's numpy formula, and takes
    # float input as already normalised
    xp = engine._normalize(imgs)
    np.testing.assert_array_equal(xp, (
        (imgs.astype(np.float32) / 255.0 - np.float32(cfg.data.mean))
        / np.float32(cfg.data.std)))
    np.testing.assert_allclose(xp, x[:5], rtol=0, atol=1e-6)
    m2, p2 = engine.predict(xp)
    np.testing.assert_array_equal(m2, masks)
    np.testing.assert_array_equal(p2, probs)


def test_async_batcher_serves_port_engine(served):
    cfg, _, _, sd = served
    engine = InferenceEngine(cfg, state_dict=sd, batch_size=4, device="cpu")
    imgs = _images(3, 2)
    batcher = AsyncBatcher(engine, max_wait_ms=50.0)
    try:
        futs = [batcher.submit(im) for im in imgs]
        got = [f.result(timeout=60.0) for f in futs]
    finally:
        batcher.shutdown()
    ref_m, ref_p = engine.predict(imgs)
    for i, (m, p) in enumerate(got):
        np.testing.assert_array_equal(m, ref_m[i])
        np.testing.assert_allclose(p, ref_p[i], atol=1e-6)
    assert batcher.stats()["requests"] == 3


def test_pth_roundtrip_strict(served, tmp_path):
    """save_pth's training-dict format, a DataParallel 'module.' dict and
    a raw state dict all load with strict=True."""
    from uaps_tpu.utils.torch_import import save_pth
    cfg, _, variables, sd = served
    paths = {"save_pth": tmp_path / "a.pth", "module": tmp_path / "b.pth",
             "raw": tmp_path / "c.pth"}
    save_pth(str(paths["save_pth"]), variables["params"],
             variables["batch_stats"], extra={"epoch": 3})
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 1}, paths["module"])
    torch.save(sd, paths["raw"])
    for name, path in paths.items():
        model = load_pth(build_model(cfg, "cpu",
                                     torch.Generator().manual_seed(9)),
                         str(path))
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (name, k)
    engine = InferenceEngine.from_torch(cfg, str(paths["raw"]),
                                        device="cpu")
    assert engine.batch_size == cfg.data.batch_size
    bad = dict(sd)
    bad.pop("main_decoder.out_conv.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        InferenceEngine(cfg, state_dict=bad, device="cpu")


def test_engine_contract_errors(served, tmp_path):
    cfg, _, _, sd = served
    with pytest.raises(ValueError, match="exactly one"):
        InferenceEngine(cfg, device="cpu")
    # tta is ported: the probs are the flips' mean softmax (ops/tta.py)
    tta = InferenceEngine(cfg, state_dict=sd, device="cpu", tta=True)
    masks, probs = tta.predict(_images(2, 3))
    with torch.inference_mode():
        want = flip_tta_softmax(tta._forward, torch.from_numpy(
            tta._normalize(_images(2, 3))))
    np.testing.assert_array_equal(probs, want.numpy())
    np.testing.assert_array_equal(masks, want.argmax(-1).numpy())
    engine = InferenceEngine(cfg, state_dict=sd, device="cpu")
    # uncertainty() is ported: one KL map per image, repeatable
    u = engine.uncertainty(_images(1, 0))
    assert u.shape == (1, *HW) and u.dtype == np.float32
    assert np.isfinite(u).all() and (u >= -1e-6).all()
    np.testing.assert_array_equal(u, engine.uncertainty(_images(1, 0)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(cfg, state_dict=sd, device="cuda")
        # export is ported (tests/test_torch_port_export.py); its loader
        # refuses a card that is not there before it reads the program
        head = json.dumps({"device": "cpu"}).encode()
        path = tmp_path / "header_only.export"
        path.write_bytes(len(head).to_bytes(8, "little") + head)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedEngine(str(path), device="cuda")


@pytest.mark.parametrize("argv,method,data,model", [
    ([], "uaps", {}, {}),
    (["--preset", "neu", "--method", "uaps", "--dtype", "bfloat16",
      "--ckpt", "model.pth", "--port", "0"],
     "uaps", {}, {"compute_dtype": "bfloat16"}),
    (["--preset", "neu", "--method", "baseline", "--model", "unet",
      "--num_classes", "5", "--batch_size", "8", "--n_aux", "2",
      "--head_variant", "xla"],
     "baseline", {"num_classes": 5, "batch_size": 8},
     {"name": "unet", "n_aux": 2, "head_variant": "xla"})])
def test_cli_builds_preset_config(argv, method, data, model):
    """The serving flags override the preset as the JAX CLI
    (uaps_tpu/train.py parse_args) does; flags they do not name (--ckpt,
    --port) are left to the caller's parser."""
    from uaps_tpu_torch.utils.cli import parse_args
    name = "neu" if "neu" in argv else "synthetic"
    want = preset(name, method=method)
    want.data = dataclasses.replace(want.data, **data)
    want.model = dataclasses.replace(want.model, **model)
    assert dataclasses.asdict(parse_args(argv)[0]) == dataclasses.asdict(want)


def test_enum_table_matches_jax():
    from uaps_tpu.methods.base import _MODEL_ENUMS as jax_enums
    from uaps_tpu_torch.methods.base import _MODEL_ENUMS
    assert _MODEL_ENUMS == jax_enums


def _imports(path):
    """Absolute module names a file imports, anywhere in it."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_no_jax():
    """No file of uaps_tpu_torch/ nor chip_smoke.py imports uaps_tpu, jax,
    flax, optax, orbax or sklearn (AST scan); and a fresh interpreter in which
    `import uaps_tpu` fails imports every port module and chip_smoke and
    loads none of them."""
    files = sorted((REPO / "uaps_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    modules = ["chip_smoke"] + [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in files if p.parent.name != "" and "uaps_tpu_torch" in p.parts]
    # the kernels' operators, the artifact's loader, the ResNet BaseNets,
    # the step timer and the data-parallel modules are among them
    assert {"uaps_tpu_torch.kernels.custom_ops", "uaps_tpu_torch.artifact",
            "uaps_tpu_torch.models.resnet", "uaps_tpu_torch.step_times",
            "uaps_tpu_torch.parallel.mesh", "uaps_tpu_torch.parallel.ranks",
            "uaps_tpu_torch.parallel.shardmap_step"} <= set(modules)
    code = ("import importlib, sys\n"
            "sys.modules['uaps_tpu'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = {sorted(FORBIDDEN)!r}\n"
            "hit = [m for m in sys.modules if m.split('.')[0] in bad\n"
            "       and sys.modules[m] is not None]\n"
            "assert not hit, hit\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("method", ["baseline", "uaps"])
def test_weight_mapping_matches_export(method):
    """The port's flax -> torch mapping equals the JAX package's
    export_state_dict, key for key and value for value (unet and
    unet_uaps)."""
    from uaps_tpu.utils.torch_import import export_state_dict
    v = seeded_variables(jax_build_model(neu_config(method)), HW, 3)
    want = export_state_dict(v["params"], v["batch_stats"])
    got = state_dict_from_jax(v["params"], v["batch_stats"])
    assert set(got) == set(want)
    for k, ref in want.items():
        assert got[k].dtype == torch.from_numpy(np.asarray(ref)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref),
                                      err_msg=k)


def test_config_matches_jax(tmp_path, monkeypatch):
    """The port's config tree equals the JAX package's: every dataclass
    field and default, and every preset (with image roots discovered
    under $UAPS_DATA_ROOT)."""
    from uaps_tpu.utils import config as jc
    from uaps_tpu_torch.utils import config as pc
    for name in ("DataConfig", "ModelConfig", "MethodConfig",
                 "OptimConfig", "RunConfig", "Config"):
        assert (dataclasses.asdict(getattr(pc, name)())
                == dataclasses.asdict(getattr(jc, name)())), name
    (tmp_path / "neu" / "images").mkdir(parents=True)
    monkeypatch.setenv("UAPS_DATA_ROOT", str(tmp_path))
    assert sorted(pc.PRESETS) == sorted(jc.PRESETS)
    for name in pc.PRESETS:
        for kw in ([{}] if name not in ("neu", "synthetic")
                   else [{"method": "uaps"}, {"method": "baseline"}]):
            got = dataclasses.asdict(pc.preset(name, **kw))
            assert got == dataclasses.asdict(jc.preset(name, **kw)), name
    assert pc.preset("neu").data.image_root == str(tmp_path / "neu" /
                                                   "images")


class _StubEngine:
    """A 2-image fixed-batch engine: mask = channel 0 > 127."""
    batch_size = 2

    def predict(self, images):
        masks = (images[..., 0] > 127).astype(np.int32)
        return masks, np.zeros(images.shape[:3] + (1,), np.float32)


def test_http_front_surface():
    """POST /predict (one image and a batch), GET /healthz and /stats, 404
    and 400, as uaps_tpu/server.py serves them."""
    batcher = AsyncBatcher(_StubEngine(), max_wait_ms=1.0)
    srv = serve_http(batcher, port=0, host="127.0.0.1")
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        imgs = _images(3, 4)

        def post(arr):
            buf = io.BytesIO()
            np.save(buf, arr)
            req = urllib.request.Request(f"{url}/predict",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return np.load(io.BytesIO(r.read()))

        np.testing.assert_array_equal(post(imgs[0]),
                                      imgs[0, ..., 0] > 127)
        np.testing.assert_array_equal(post(imgs), imgs[..., 0] > 127)
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            assert r.read() == b"ok"
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            assert json.loads(r.read())["requests"] == 4
        for path, data, code in (("/nope", None, 404),
                                 ("/predict", b"junk", 400)):
            req = urllib.request.Request(url + path, data=data,
                                         method="POST" if data else "GET")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=60)
            assert e.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.shutdown()
