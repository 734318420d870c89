"""The port's checkpoints against the JAX package's on the CPU: the
`CheckpointManager` (utils/checkpoint.py) against JAX's Orbax manager on
one save sequence, resume against the uninterrupted run, `--resume`
through the CLI, `debug_nans` and `halt_on_nan`.

Resume is held bit for bit: a run of 2 epochs (save_every 1, keep 2)
against a run of 1 epoch followed by a fresh Trainer that resumes and
runs epoch 2, both with device pools (which draw the same batches for an
epoch whatever ran before: the host stream starts over on resume, as in
JAX), at 32 x 32, batch 4, 2 steps an epoch as one K = 2 dispatch (the
K-step function that a CUDA graph captures on the card). Every tensor of
the run (`state_tensors`: parameters, BN buffers, Adam's moments, steps
and lr, the counter, the generators, the teacher, net 2) must be equal,
and so must the best dice, the schedulers and epoch 2's metrics line
(but its wall-clock fields).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from uaps_tpu.utils.checkpoint import CheckpointManager as JaxManager
from uaps_tpu_torch import train
from uaps_tpu_torch.data import SyntheticDefects
from uaps_tpu_torch.utils.checkpoint import CheckpointManager, state_tensors
from uaps_tpu_torch.utils.config import preset

# (step, val_mdice): a tie with a kept step (5), saves worse than every
# kept one (4, 7) and a new best (6)
SAVES = [(1, 0.3), (2, 0.9), (3, 0.6), (4, 0.1), (5, 0.6), (6, 0.95),
         (7, 0.2), (8, 0.6)]


def _jax_state(step):
    return {"w": jnp.full((2, 3), float(step)),
            "step": jnp.asarray(step, jnp.int32)}


@pytest.mark.parametrize("keep", [2, 3])
def test_manager_keeps_ranks_and_restores_as_orbax(tmp_path, keep):
    """The same saves through JAX's manager (Orbax, best_fn val_mdice,
    max, max_to_keep = keep) and the port's: after each save the same kept
    steps, latest_step and best_step; every kept step restores its host
    state and its tensors."""
    jm = JaxManager(str(tmp_path / "jax"), keep=keep)
    pm = CheckpointManager(str(tmp_path / "port"), keep=keep)
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape,
                                                           x.dtype),
                            _jax_state(0))
    for step, dice in SAVES:
        host = {"epoch": step, "best_dice": dice, "sched_best": -1.5}
        jm.save(step, _jax_state(step), host_state=host,
                metrics={"val_mdice": dice, "val_miou": dice / 2})
        pm.save(step, {"w": torch.full((2, 3), float(step))},
                host_state=host,
                metrics={"val_mdice": dice, "val_miou": dice / 2})
        jm.wait()
        assert pm.steps() == sorted(jm._mngr.all_steps()), step
        assert pm.latest_step() == jm.latest_step(), step
        assert pm.best_step() == jm.best_step(), step
    for step in pm.steps():
        js, jh = jm.restore(abstract, step=step)
        ps, ph = pm.restore(step)
        assert ph == jh == {"epoch": step, "best_dice": dict(SAVES)[step],
                            "sched_best": -1.5}
        assert int(js["step"]) == step
        assert torch.equal(ps["w"], torch.full((2, 3), float(step)))
    latest, _ = pm.restore()
    assert torch.equal(latest["w"], torch.full((2, 3),
                                               float(pm.latest_step())))
    assert not list((tmp_path / "port").glob("*.tmp-*"))
    jm.close()


def test_empty_dir_restores_none(tmp_path):
    """No checkpoint: (None, None), no step, as JAX's manager."""
    pm = CheckpointManager(str(tmp_path / "empty"))
    assert pm.restore() == (None, None)
    assert pm.latest_step() is None and pm.best_step() is None


# ------------------------------------------------------------------ resume
def _cfg(out_dir, method, **run_kw):
    cfg = preset("synthetic", method=method)
    cfg.data = dataclasses.replace(cfg.data, image_size=(32, 32),
                                   batch_size=4)
    if method == "uaps":
        cfg.model = dataclasses.replace(cfg.model, n_aux=1)
    run = {"epochs": 2, "iter_per_epoch": 2, "seed": 5,
           "device_pools": True, "steps_per_dispatch": 2,
           "save_every": 1, "keep_checkpoints": 2,
           "out_dir": str(out_dir), **run_kw}
    cfg.run = dataclasses.replace(cfg.run, **run)
    return cfg


def _trainer(cfg):
    data = SyntheticDefects(cfg.data, seed=cfg.run.seed, labeled_pool=8,
                            unlabeled_pool=8, val_pool=4)
    return train.Trainer(cfg, device="cpu", data=data)


def _lines(out_dir):
    """The metrics lines by epoch, without the wall-clock fields."""
    recs = [json.loads(s) for s in
            (out_dir / "metrics.jsonl").read_text().splitlines()]
    return {r.pop("step"): {k: v for k, v in r.items()
                            if k not in ("time", "imgs_per_sec")}
            for r in recs}


@pytest.mark.parametrize("method", ["uaps", "mt", "cps", "ucc"])
def test_resume_equals_uninterrupted_run(tmp_path, method):
    """2 epochs in one run against 1 epoch, then a fresh Trainer that
    resumes from its checkpoint and runs epoch 2: the same tensors bit for
    bit, the same host state and the same epoch-2 metrics line; the
    checkpoints are the run's at steps 2 and 4."""
    whole = _trainer(_cfg(tmp_path / "whole", method))
    whole.run()
    first = _trainer(_cfg(tmp_path / "cut", method, epochs=1))
    first.run()
    resumed = _trainer(_cfg(tmp_path / "cut", method))
    assert resumed.maybe_resume() == 1 and resumed.state.step == 2
    resumed.run(resume=True)

    assert whole.ckpt.steps() == resumed.ckpt.steps() == [2, 4]
    a = state_tensors(whole.state, whole.model, whole.pools)
    b = state_tensors(resumed.state, resumed.model, resumed.pools)
    assert a.keys() == b.keys()
    assert any(k.startswith("optimizer.state.") for k in a)
    assert ("ema_model.decoder.out_conv.weight" in a) == (method == "mt")
    assert ("second.optimizer.lr" in a) == (method == "cps")
    assert ("pools.generator" in a) == (method == "ucc")
    for k, v in a.items():
        assert torch.equal(b[k], v), k
    assert resumed.best_dice == whole.best_dice
    assert resumed.epochs_since_best == whole.epochs_since_best
    assert resumed._sched_host() == whole._sched_host()
    assert _lines(tmp_path / "cut")[2] == _lines(tmp_path / "whole")[2]
    saved, host = whole.ckpt.restore(4)
    assert host["epoch"] == 2 and saved.keys() == a.keys()
    for k, v in a.items():
        assert torch.equal(saved[k], v), k


def test_resume_through_main(tmp_path):
    """`python -m uaps_tpu_torch.train --resume` with no checkpoint trains
    from epoch 1; run again with --epochs 2 it goes on from epoch 1's
    checkpoint (the host stream starts over) and writes epoch 2 only."""
    argv = ["--preset", "synthetic", "--method", "uaps", "--device", "cpu",
            "--iter_per_epoch", "2", "--batch_size", "2", "--n_aux", "1",
            "--out_dir", str(tmp_path), "--resume"]
    train.main(argv + ["--epochs", "1"])
    (step,) = CheckpointManager(str(tmp_path / "checkpoints")).steps()
    assert step == 2
    train.main(argv + ["--epochs", "2"])
    assert sorted(_lines(tmp_path)) == [1, 2]
    assert "resumed from step 2 (epoch 1" in (tmp_path
                                               / "run.log").read_text()


# ---------------------------------------------------- NaN: debug and halt
def test_debug_nans_names_the_module(tmp_path):
    """debug_nans: single eager steps (no K-step dispatch) that raise
    FloatingPointError naming the first module whose output holds a NaN:
    here the conv whose weight was set to NaN."""
    t = _trainer(_cfg(tmp_path, "uaps", debug_nans=True))
    assert t.k_dispatch == 1
    conv = t.model.encoder.down1.maxpool_conv[1].conv_conv[0]
    with torch.no_grad():
        conv.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"'encoder\.down1\.maxpool_conv\.1\."
                             r"conv_conv\.0'"):
        t.run()


def test_halt_on_nan_names_last_good_step(tmp_path):
    """halt_on_nan: a NaN weight from epoch 2 on gives a non-finite loss,
    and the error names epoch 1's checkpoint, the last good step."""
    t = _trainer(_cfg(tmp_path, "uaps"))
    start = t.pools.start_epoch

    def poisoned(epoch):
        if epoch == 2:
            with torch.no_grad():
                t.model.encoder.in_conv.conv_conv[0].weight.fill_(
                    float("nan"))
        start(epoch)

    t.pools.start_epoch = poisoned
    with pytest.raises(FloatingPointError,
                       match="at epoch 2; last good checkpoint: step 2"):
        t.run()
