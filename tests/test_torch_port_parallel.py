"""The port's data-parallel training (uaps_tpu_torch/parallel/) against the
JAX package on the CPU, over 2 ranks.

The ranks are processes spawned with torch.multiprocessing, joined over
gloo through a file store in tmp_path, one spawn a mode for all of its
cases (tests/_torch_port_ranks.py `spawn`); they import torch and the
port, never JAX. The recipe is the deterministic one of the method tests
(tests/_torch_port_util.py): perturbations "none" and dropout 0 on both
sides, the same seeded f32 weights, a fixed `mix_w` for UAPS and the
teacher's noise through JAX's `tnoise` hook for mt, f64 activations, at
32 x 32 with a global batch of 4 + 4 (2 + 2 a rank) and narrow widths.

  * shard_map mode: JAX's reference is its own step with
    axis_name="data" under jax.vmap over the two row blocks
    (`jax_method_runs(shards=2)`), whose pmeans are those of jax.shard_map
    on two devices; baseline and uaps take 2 steps (uaps past its ramp, so
    the pseudo-label terms weigh), mt 2 from consistency_start_iter (its
    teacher's EMA and BN stats), cps 2 past its ramp (two nets);
  * GSPMD mode: baseline and uaps on 2 ranks with sync BN and the losses'
    sums all-reduced, held to JAX's step on the global batch;
  * the tolerances are check_method_steps' (metrics rtol 1e-5, params atol
    2e-6 past Adam's sign noise, BN stats rtol 1e-4 / atol 1e-5, Adam's
    moments rtol 1e-4 / atol 1e-5 of the largest), and the two ranks'
    states after every step are equal bit for bit;
  * a group of one rank gives the bits of no group;
  * with dropout and every perturbation on, GSPMD mode's 2 ranks take the
    single-process step on the global batch (their masks are its rows),
    and shard_map mode's ranks stay bit-equal (their seeds differ);
  * validation over 2 ranks (`Trainer.validate`, a remainder batch run
    whole) equals JAX's eval step on the global batches, and a 2-rank save
    and resume restores both ranks bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_ranks import make_net, method_cases, spawn
from _torch_port_util import torch_threads  # noqa: F401 (autouse)
from _torch_port_util import (check_method_steps, jax_runs, neu_config,
                              port_method_runs, seeded_variables)
from uaps_tpu.methods import base as jbase
from uaps_tpu.methods import baseline as jbaseline
from uaps_tpu.methods import cps as jcps
from uaps_tpu.methods import mt as jmt
from uaps_tpu.methods import uaps as juaps
from uaps_tpu.models import unet as junet
from uaps_tpu_torch.methods import get_method
from uaps_tpu_torch.models import unet as tunet
from uaps_tpu_torch.models.factory import init_weights
from uaps_tpu_torch.parallel import ranks as pranks
from uaps_tpu_torch.utils.weights import load_jax_params

HW = (32, 32)
B = 4          # the global batch; 2 a rank
WORLD = 2
FEATURES = (4, 8, 16, 32, 64)
STEPS = 2
NET = dict(features=FEATURES, dropout=(0.0,) * 5)
PLAIN_NET = dict(nchw_levels=2, head_variant="dwmf", **NET)


def _cfgs(method, shard_map=True):
    """(JAX's config, the port's) from each package's preset, f32, at HW
    and B; the port's in shard_map or GSPMD mode."""
    from uaps_tpu_torch.utils.config import preset as port_preset
    out = []
    for cfg in (neu_config(method, "float32"),
                port_preset("neu", method=method)):
        cfg.model = dataclasses.replace(cfg.model, compute_dtype="float32",
                                        n_aux=1)
        cfg.data = dataclasses.replace(cfg.data, image_size=HW,
                                       batch_size=B)
        out.append(cfg)
    out[1].run = dataclasses.replace(out[1].run, use_shard_map=shard_map)
    if not shard_map:   # the Trainer's GSPMD routing
        out[1].model = dataclasses.replace(out[1].model, conv_backend="xla")
    return out


def _jax_net(kind, dtype):
    if kind == "UNet":
        return junet.UNet(num_classes=4, conv_variant="dwmf",
                          head_variant="dwmf", nchw_levels=2, dtype=dtype,
                          **NET)
    if kind == "MultiDecoderUNet":
        return junet.MultiDecoderUNet(num_classes=4, perturbations=("none",),
                                      conv_variant="dwmf",
                                      head_variant="dwmf", nchw_levels=2,
                                      dtype=dtype, **NET)
    return junet.DeepSupervisionUNet(num_classes=4, perturbation="none",
                                     dtype=dtype, **NET)


def _port_kwargs(kind, backend="auto"):
    if kind == "UNet":
        return dict(num_classes=4, dtype=torch.float64,
                    conv_backend=backend, **PLAIN_NET)
    if kind == "MultiDecoderUNet":
        return dict(num_classes=4, perturbations=("none",),
                    dtype=torch.float64, conv_backend=backend, **PLAIN_NET)
    return dict(num_classes=4, perturbation="none", dtype=torch.float64,
                conv_backend=backend, **NET)


def _port_sd(kind, v):
    """The port's state dict of net `kind` from JAX variables v."""
    net = getattr(tunet, kind)(**_port_kwargs(kind))
    return load_jax_params(net, v["params"], v["batch_stats"]).state_dict()


def _batches(method, seed, steps=STEPS, n_dec=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = {"image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "uimage": rng.standard_normal((B, *HW, 3)).astype(np.float32),
             "label": rng.integers(0, 4, (B, *HW)).astype(np.int32)}
        if method == "uaps":
            b["mix_w"] = np.asarray(rng.dirichlet((1.0,) * n_dec),
                                    np.float32)
        if method == "mt":
            b["tnoise"] = np.clip(0.1 * rng.standard_normal((B, *HW, 3)),
                                  -0.2, 0.2).astype(np.float32)
        out.append(b)
    return out


# method: (net, weight seed, batch seed, start of the 2 steps)
CASES = {
    "baseline": ("UNet", 71, 72, lambda c: 0),
    "uaps": ("MultiDecoderUNet", 73, 74,
             lambda c: int(c.method.ramp_iters * c.method.consistency_rampup)),
    "mt": ("UNet", 75, 76, lambda c: c.method.consistency_start_iter),
    "cps": ("DeepSupervisionUNet", 77, 78,
            lambda c: int(150 * c.method.consistency_rampup)),
}
JAX_METHODS = {"baseline": jbaseline, "uaps": juaps, "mt": jmt, "cps": jcps}
GSPMD = ("baseline", "uaps")


def _case(method, shard_map):
    """(JAX job args and kwargs, the port's case for the ranks)."""
    kind, wseed, bseed, start = CASES[method]
    cfg, pcfg = _cfgs(method, shard_map)
    v = seeded_variables(_jax_net(kind, jnp.float32), HW, wseed)
    batches = _batches(method, bseed)
    starts = (start(cfg),)
    kw = {"shards": WORLD if shard_map else 1}
    make = functools.partial(
        make_net, kind,
        _port_kwargs(kind, "auto" if shard_map else "xla"),
        _port_sd(kind, v))
    case = dict(method=method, cfg=pcfg, make=make, batches=batches,
                starts=starts, teacher=method == "mt", make_second=None)
    if method == "mt":
        kw["teacher"] = True
    if method == "cps":
        v2 = seeded_variables(_jax_net(kind, jnp.float32), HW, wseed + 100)
        kw["second"] = v2
        case["make_second"] = functools.partial(
            make_net, kind, _port_kwargs(kind), _port_sd(kind, v2))
    job = ((JAX_METHODS[method], cfg, _jax_net(kind, jnp.float64), v,
            batches, starts), kw)
    return cfg, job, case


def _mode_runs(methods, shard_map, extra_work, tmp_path):
    """JAX's runs of each method (one after the other), then one spawn of
    the ranks for all of the mode's cases: {method: (cfg, JAX runs, JAX
    step-1 gradients, [the port's runs on each rank])}, and the extra
    work's results per rank."""
    cfgs, jobs, cases = {}, {}, {}
    for m in methods:
        cfgs[m], jobs[m], cases[m] = _case(m, shard_map)
    out = {}
    for m, (jruns, jgrads) in jax_runs(jobs):
        cases[m]["jruns"] = jruns
        out[m] = [cfgs[m], jruns, jgrads]
    results = spawn(method_cases, (cases, extra_work), WORLD, tmp_path)
    for m in methods:
        out[m].append([r["runs"][m] for r in results])
    return out, [r["extra"] for r in results]


def _eval_case(tmp_path):
    """The extra work of the shard_map spawn: a Trainer on each rank whose
    validation runs the narrow f64 UAPS net (uaps' weights) on a batch of
    4 and a remainder batch of 3, then one step, a save and a resume."""
    kind, wseed = CASES["uaps"][:2]
    v = seeded_variables(_jax_net(kind, jnp.float32), HW, wseed)
    from uaps_tpu_torch.utils.config import preset as port_preset
    cfg = port_preset("synthetic", method="uaps")
    cfg.data = dataclasses.replace(cfg.data, image_size=HW, batch_size=B)
    cfg.model = dataclasses.replace(cfg.model, n_aux=1)
    cfg.run = dataclasses.replace(cfg.run, device_pools=False, seed=5,
                                  out_dir=str(tmp_path / "trainer"))
    rng = np.random.default_rng(79)
    val = [{"image": rng.standard_normal((n, *HW, 3)).astype(np.float32),
            "label": rng.integers(0, 4, (n, *HW)).astype(np.int32)}
           for n in (B, 3)]
    train = _batches("uaps", 80, 1)[0]
    make = functools.partial(make_net, kind, _port_kwargs(kind),
                             _port_sd(kind, v))
    return dict(trainer=(cfg, val, train, make), one=["baseline", "uaps"]), \
        v, val


@pytest.fixture(scope="module")
def shard_map_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_map")
    extra, v, val = _eval_case(tmp)
    runs, extras = _mode_runs(list(CASES), True, extra, tmp)
    return runs, extras, v, val


@pytest.fixture(scope="module")
def gspmd_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gspmd")
    kind = CASES["baseline"][0]
    kernel_cfg = _cfgs("baseline", shard_map=False)[1]
    kernel_cfg.model = dataclasses.replace(kernel_cfg.model,
                                           conv_backend="auto")
    extra = {"dropout": _dropout_case(),
             "kernel_route": (kernel_cfg, functools.partial(
                 make_net, kind, _port_kwargs(kind), _port_sd(
                     kind, seeded_variables(_jax_net(kind, jnp.float32),
                                            HW, CASES["baseline"][1]))))}
    runs, extras = _mode_runs(GSPMD, False, extra, tmp)
    return runs, extras


def _check_ranks_equal(pruns):
    """Both ranks' records after every step, bit for bit."""
    a, b = pruns
    for start in a:
        for ra, rb in zip(a[start], b[start]):
            assert ra["metrics"] == rb["metrics"]
            for part in ("sd", "mu", "nu"):
                for k, x in ra[part].items():
                    np.testing.assert_array_equal(rb[part][k], x, err_msg=k)
            for net in ("ema", "second"):
                if ra[net] is not None:
                    sa = ra[net] if net == "ema" else ra[net]["sd"]
                    sb = rb[net] if net == "ema" else rb[net]["sd"]
                    for k, x in sa.items():
                        np.testing.assert_array_equal(sb[k], x, err_msg=k)


@pytest.mark.parametrize("method", list(CASES))
def test_shard_map_steps_match_jax(shard_map_runs, method):
    """Each method's 2 steps on 2 ranks against JAX's axis_name="data"
    step under vmap, and the ranks bit-equal."""
    runs = shard_map_runs[0][method]
    cfg, jruns, jgrads, pruns = runs
    _check_ranks_equal(pruns)
    (s0,) = jruns
    check_method_steps(jruns[s0], pruns[0][s0], jgrads[s0],
                       cfg.optim.base_lr)


@pytest.mark.parametrize("method", GSPMD)
def test_gspmd_steps_match_jax(gspmd_runs, method):
    """GSPMD mode's 2 steps on 2 ranks (sync BN, global losses) against
    JAX's step on the global batch, and the ranks bit-equal; on the
    kernel route (conv_backend "auto") the GSPMD step refuses to build on
    every rank, as JAX routes GSPMD mode to the plain ops."""
    for extra in gspmd_runs[1]:
        assert "conv_backend='xla'" in extra["kernel_route"]
    cfg, jruns, jgrads, pruns = gspmd_runs[0][method]
    _check_ranks_equal(pruns)
    (s0,) = jruns
    check_method_steps(jruns[s0], pruns[0][s0], jgrads[s0],
                       cfg.optim.base_lr)


@pytest.mark.parametrize("method", ["baseline", "uaps"])
def test_group_of_one_is_no_group(shard_map_runs, method):
    """On each rank, a step over a process group of that rank alone gives
    the bits of the step without a group (the all-reduce of one rank, the
    mean over one, the seeds unfolded)."""
    for extra in shard_map_runs[1]:
        one, none = extra["one"][method]
        _check_ranks_equal([one, none])


def test_validation_over_ranks_matches_jax(shard_map_runs):
    """Trainer.validate on 2 ranks (each its rows of the batch of 4, the
    class counts and sums all-reduced; the remainder batch of 3 whole on
    every rank) equals the mean of JAX's eval step on the two global
    batches, on both ranks, at check_method_steps' metric tolerance
    (rtol 1e-5: the logits heads are f32 in both packages)."""
    _, extras, v, val = shard_map_runs
    model = _jax_net("MultiDecoderUNet", jnp.float64)
    with jax.enable_x64(True):
        step = jbase.make_eval_step(_cfgs("uaps")[0], model)
        v64 = jax.tree.map(lambda x: np.asarray(x, np.float64), v)
        ms = [jax.device_get(step(v64["params"], v64["batch_stats"],
                                  {k: jnp.asarray(x) for k, x in b.items()}))
              for b in val]
    want = {k: np.mean([float(m[k]) for m in ms]) for k in ms[0]}
    for extra in extras:
        got = extra["validate"]
        assert set(got) == set(want)
        for k, x in want.items():
            np.testing.assert_allclose(got[k], x, rtol=1e-5, err_msg=k)


def test_checkpoint_resume_over_ranks(shard_map_runs):
    """After one shard_map step of the synthetic preset's UAPS net
    (dropout and every perturbation on) rank 0 saves; a fresh Trainer on
    each rank resumes: every state tensor (parameters, BN stats, Adam,
    counter, generator) equals the saved run's bit for bit, and the two
    ranks hold the same state."""
    extras = shard_map_runs[1]
    for extra in extras:
        assert extra["resume_equal"], extra["resume_equal"]
        assert extra["step"] == 1
    assert extras[0]["digest"] == extras[1]["digest"]


def _dropout_case():
    """GSPMD mode with dropout and every perturbation on: the UAPS step of
    a narrow MultiDecoderUNet (feature noise, dropout, feature dropout;
    the default dropout rates), one step past the ramp."""
    cfg, pcfg = _cfgs("uaps", shard_map=False)
    kwargs = dict(num_classes=4, dtype=torch.float64, conv_backend="xla",
                  nchw_levels=2, head_variant="dwmf", features=FEATURES)
    net = tunet.MultiDecoderUNet(**kwargs)
    init_weights(net, torch.Generator().manual_seed(3))
    sd = net.state_dict()
    make = functools.partial(make_net, "MultiDecoderUNet", kwargs,
                             sd)
    start = int(cfg.method.ramp_iters * cfg.method.consistency_rampup)
    return dict(method="uaps", cfg=pcfg, make=make,
                batches=_batches("uaps", 81, 1, n_dec=4), starts=(start,),
                teacher=False, make_second=None, jruns=None)


def test_gspmd_draws_are_the_global_batch(gspmd_runs):
    """With dropout and every perturbation on, GSPMD mode's 2 ranks take
    the step of one process on the global batch: their dropout masks are
    its rows, the noise and the feature-dropout scale its shared draws
    (check_method_steps' tolerances, against that step's gradient)."""
    c = _dropout_case()
    (s0,) = c["starts"]
    single = port_method_runs(get_method("uaps"), c["cfg"], c["make"],
                              c["batches"], c["starts"], None)
    grad = {k: v / (1 - c["cfg"].optim.b1)
            for k, v in single[s0][0]["mu"].items()}
    for rec in single[s0]:   # as JAX's records hold them
        rec["sd"] = {k: v for k, v in rec["sd"].items()
                     if not k.endswith("num_batches_tracked")}
    ranks = [extra["dropout"] for extra in gspmd_runs[1]]
    _check_ranks_equal(ranks)
    check_method_steps(single[s0], ranks[0][s0], grad,
                       c["cfg"].optim.base_lr)


def test_local_batch_shard_and_data_ranks_match_jax(monkeypatch):
    """data_ranks is JAX's mesh rule (train.py:81-85); local_batch_shard
    gives each rank JAX's rows (its process index monkeypatched), mix_w
    whole, and refuses a batch the ranks do not divide."""
    from uaps_tpu.parallel import mesh as jmesh
    from uaps_tpu_torch.parallel.mesh import data_ranks, local_batch_shard
    for batch in (1, 4, 6, 12, 16):
        for avail in (1, 2, 3, 4, 8):
            want = max(d for d in range(1, avail + 1) if batch % d == 0)
            assert data_ranks(batch, avail) == want
    b = _batches("uaps", 9, 1)[0]
    for world in (1, 2, 4):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda: rank)
            want = jmesh.local_batch_shard(
                {k: x for k, x in b.items() if k != "mix_w"})
            got = local_batch_shard(b, rank, world)
            for k, x in want.items():
                np.testing.assert_array_equal(got[k], np.asarray(x))
            np.testing.assert_array_equal(got["mix_w"], b["mix_w"])
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_shard({"image": np.zeros((3, 2))}, 0, 2)


def test_rank_draws():
    """What a rank's forward draws (parallel/ranks.py, no collective):
    shard_map mode folds the rank into the model's seeds (rank 0 keeps
    them), GSPMD mode keeps them shared and offsets dropout by the rank's
    first element; a per-example draw is the rank's rows of the global
    batch's draw, whose generator advances alike on every rank."""
    from uaps_tpu_torch.methods.mt import teacher_noise
    from uaps_tpu_torch.ops.perturbations import dropout

    def draw(r, sync):
        g = torch.Generator().manual_seed(4)
        with pranks.scope(pranks.Ranks(None, r, WORLD, sync)):
            seeds = tunet.draw_seeds(g, 5, torch.device("cpu"))
            x = torch.ones(2, 3, 4, 4, dtype=torch.float64)
            noise = teacher_noise(g, torch.zeros(2, 4, 4, 3), samples=1)
            drop = dropout(seeds[0], x, 0.5, pranks.row_offset(x))
        return seeds, noise, drop, g.get_state()

    g = torch.Generator().manual_seed(4)
    seeds = tunet.draw_seeds(g, 5, torch.device("cpu"))
    noise = teacher_noise(g, torch.zeros(4, 4, 4, 3))
    drop = dropout(seeds[0], torch.ones(4, 3, 4, 4, dtype=torch.float64),
                   0.5)
    for sync in (False, True):
        r0, r1 = draw(0, sync), draw(1, sync)
        torch.testing.assert_close(r0[0], seeds, rtol=0, atol=0)
        assert (r1[0] == seeds).all() == sync
        assert (r1[0] >= 0).all() and (r1[0] < 2 ** 31 - 1).all()
        torch.testing.assert_close(torch.cat([r0[1], r1[1]]), noise,
                                   rtol=0, atol=0)
        assert torch.equal(r0[3], r1[3])
        if sync:
            torch.testing.assert_close(torch.cat([r0[2], r1[2]]), drop,
                                       rtol=0, atol=0)


def test_cli_one_rank_runs_as_before(tmp_path):
    """--num_devices 1 trains in this process as without the flag (no
    process group is left behind); the CLI's --gspmd and --shard_map set
    RunConfig.use_shard_map."""
    import torch.distributed as dist
    from uaps_tpu_torch import train
    from uaps_tpu_torch.utils.cli import parse_args
    best = train.main(["--preset", "synthetic", "--device", "cpu",
                       "--num_devices", "1", "--epochs", "1",
                       "--iter_per_epoch", "1", "--batch_size", "2",
                       "--out_dir", str(tmp_path)])
    assert np.isfinite(best) and not dist.is_initialized()
    assert parse_args([])[0].run.use_shard_map is None
    assert parse_args(["--gspmd"])[0].run.use_shard_map is False
    assert parse_args(["--shard_map"])[0].run.use_shard_map is True
