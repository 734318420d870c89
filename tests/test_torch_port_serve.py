"""The port's serving path on the CPU: InferenceEngine.predict against the
JAX computation of uaps_tpu/serve.py (softmax + argmax over main_only),
AsyncBatcher in front of the port's engine, the .pth hand-off, the enum
table, and the rule that the port never imports jax."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import neu_config, seeded_variables
from uaps_tpu import native
from uaps_tpu.methods.base import build_model as jax_build_model
from uaps_tpu.server import AsyncBatcher
from uaps_tpu.utils.config import preset
from uaps_tpu_torch.methods.base import build_model
from uaps_tpu_torch.serve import InferenceEngine
from uaps_tpu_torch.utils.weights import load_pth, state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
HW = (64, 64)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}


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

    @jax.jit
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
    # float input is taken as already normalised
    m2, p2 = engine.predict(x[:5])
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


def test_engine_contract_errors(served):
    cfg, _, _, sd = served
    with pytest.raises(ValueError, match="exactly one"):
        InferenceEngine(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(cfg, state_dict=sd, device="cpu", tta=True)
    engine = InferenceEngine(cfg, state_dict=sd, device="cpu")
    for call in (lambda: engine.uncertainty(_images(1, 0)),
                 lambda: engine.export("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceEngine(cfg, state_dict=sd, device="cuda")


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
    assert parse_args(argv)[0] == want


def test_enum_table_matches_jax():
    from uaps_tpu.methods.base import _MODEL_ENUMS as jax_enums
    from uaps_tpu_torch.methods.base import _MODEL_ENUMS
    assert _MODEL_ENUMS == jax_enums


def _imports(path, module_level_only):
    """Absolute module names a file imports."""
    tree = ast.parse(path.read_text())
    nodes = tree.body if module_level_only else ast.walk(tree)
    names = []
    for node in nodes:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def _module_file(name):
    p = REPO.joinpath(*name.split("."))
    if p.with_suffix(".py").exists():
        return p.with_suffix(".py")
    if (p / "__init__.py").exists():
        return p / "__init__.py"
    return None   # an attribute, not a module


def test_port_imports_no_jax():
    """AST scan: every import anywhere in uaps_tpu_torch/ and chip_smoke.py,
    and every module-level import of the uaps_tpu modules (and their
    packages) they reach, transitively; then a fresh interpreter."""
    todo = [(p, False) for p in sorted((REPO / "uaps_tpu_torch")
                                       .rglob("*.py"))]
    todo.append((REPO / "chip_smoke.py", False))
    seen, reached = set(), set()
    while todo:
        path, module_level_only = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path, module_level_only):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if name.split(".")[0] != "uaps_tpu":
                continue
            parts = name.split(".")
            for i in range(1, len(parts) + 1):   # packages run on import
                f = _module_file(".".join(parts[:i]))
                if f is not None:
                    reached.add(".".join(parts[:i]))
                    todo.append((f, True))
    assert {"uaps_tpu.server", "uaps_tpu.utils.torch_import",
            "uaps_tpu.utils.config", "uaps_tpu.native"} <= reached
    code = ("import sys, chip_smoke, uaps_tpu_torch.server, "
            "uaps_tpu_torch.serve, uaps_tpu_torch.models.factory\n"
            f"bad = {sorted(FORBIDDEN)!r}\n"
            "hit = [m for m in sys.modules if m.split('.')[0] in bad]\n"
            "assert not hit, hit\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
